"""Command-line entry points of the port, one module per reference CLI, with
the JAX package's flags (``dissc_tpu.cli``):

  python -m dissc_tpu_torch.cli.sr_train   <->  sr/train.py
  python -m dissc_tpu_torch.cli.train_len  <->  train_len_predictor.py
  python -m dissc_tpu_torch.cli.train_f0   <->  train_f0_predictor.py

Each trains on the CUDA card unless ``--device cpu`` is given, and raises
without a card.
"""
