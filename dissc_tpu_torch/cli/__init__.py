"""Command-line entry points of the port, one module per reference CLI, with
the JAX package's flags (``dissc_tpu.cli``) plus ``--device``:

  python -m dissc_tpu_torch.cli.preprocess    <->  data/preprocess.py
  python -m dissc_tpu_torch.cli.encode        <->  data/encode.py
  python -m dissc_tpu_torch.cli.prep_dataset  <->  data/prep_dataset.py
  python -m dissc_tpu_torch.cli.train_len     <->  train_len_predictor.py
  python -m dissc_tpu_torch.cli.train_f0      <->  train_f0_predictor.py
  python -m dissc_tpu_torch.cli.infer         <->  infer.py
  python -m dissc_tpu_torch.cli.sr_train      <->  sr/train.py
  python -m dissc_tpu_torch.cli.sr_inference  <->  sr/inference.py
  python -m dissc_tpu_torch.cli.eval          <->  eval.py
  python -m dissc_tpu_torch.cli.convert_eval  <->  scripts/convert_eval.py
  python -m dissc_tpu_torch.cli.eval_sv       <->  eval_sv.py
  python -m dissc_tpu_torch.cli.convert_eval_sv  <->  scripts/convert_eval_sv.py

Each runs on the CUDA card unless ``--device cpu`` is given, and raises
without a card (``preprocess`` and ``prep_dataset`` compute on the host
and only check the flag).
"""
