"""Unit-record JSONL I/O (``dissc_tpu.data.jsonl``, copied).

The central data contract of the pipeline (reference ``data/encode.py:36-41``,
``infer.py:42-44``): one JSON object per line,
``{"units": [int], "f0": [float], "audio": "<filename>"}``.
Units are 50 Hz (320-sample hop @ 16 kHz); f0 is YAAPT at 5 ms spacing
(80-sample hop).  The reference parses lines with ``eval``; we use
``json.loads`` (identical format, documented divergence per SURVEY §7).
"""
from __future__ import annotations

import json
from typing import Dict, Iterator, List


def iter_unit_records(path: str) -> Iterator[Dict]:
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            yield json.loads(line)


def read_unit_records(path: str) -> List[Dict]:
    return list(iter_unit_records(path))


def append_unit_record(path: str, record: Dict) -> None:
    with open(path, "a+") as f:
        f.write(f"{json.dumps(record)}\n")


def write_unit_records(path: str, records: List[Dict]) -> None:
    with open(path, "w") as f:
        for r in records:
            f.write(f"{json.dumps(r)}\n")


def speaker_of(record_or_name) -> str:
    """Speaker name = filename prefix before '_' (reference ``sr/dataset.py:140-141``)."""
    name = record_or_name["audio"] if isinstance(record_or_name, dict) else record_or_name
    return name.split("_")[0]
