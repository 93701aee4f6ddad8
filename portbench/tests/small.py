"""Small runs of the benchmark on the CPU, for its tests."""

# the configuration at widths a CPU runs in seconds, and traffic to match
TINY = {"upsample_initial_channel": 32, "segment_size": 1280, "batch_size": 4,
        "hubert": {"conv_dim": [32] * 7, "hidden_size": 32, "num_heads": 2,
                   "intermediate_size": 64, "conv_pos_kernel": 16, "conv_pos_groups": 4,
                   "num_layers": 2, "output_layer": 2}}
SMALL_TRAFFIC = {
    "f32_train": {"files": 8, "lines": 64, "file_s": [0.2, 0.6]},
    "f32_convert_batch": {"records": 6, "jobs": 3, "median_s": 0.6, "clip_s": [0.2, 2.0]},
    "bf16_convert_batch": {"records": 6, "jobs": 3, "median_s": 0.6, "clip_s": [0.2, 2.0]},
    "f32_convert_call": {"calls": 5, "median_s": 0.6, "clip_s": [0.2, 2.0]},
}
CELLS = sorted(SMALL_TRAFFIC)


def small_run(cell: str, seed: int = 2 ** 31 + 11, seconds: float = 0.5):
    """One run of ``cell`` on the CPU at small widths (the chip's look skipped)."""
    import torch

    from portbench import run as R

    torch.set_num_threads(4)
    return R.run_cell(cell, seed, seconds, False, device="cpu", config_over=TINY,
                      traffic_over=SMALL_TRAFFIC[cell])
