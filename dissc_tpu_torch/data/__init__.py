"""Data: unit-record JSONL I/O and the speaker / f0 statistics files."""
