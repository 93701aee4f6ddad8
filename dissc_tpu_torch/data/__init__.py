"""Data: unit-record JSONL I/O and the speaker / f0 statistics files
(``dissc_tpu.data``)."""
from dissc_tpu_torch.data.jsonl import append_unit_record, read_unit_records, write_unit_records
from dissc_tpu_torch.data.stats import (
    calculate_pitch_stats,
    data_split,
    get_spkrs_dict,
    load_f0_stats,
    load_id_to_spkr,
    prep_stats_arrays,
    save_f0_stats,
    save_id_to_spkr,
)
