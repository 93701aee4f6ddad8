"""Data parallelism over CUDA cards (``dissc_tpu.parallel``).

* :mod:`~dissc_tpu_torch.parallel.distributed`: joining a process group
  (torchrun's environment or this package's own launcher), the rank's card,
  and the rank-0 duties;
* :mod:`~dissc_tpu_torch.parallel.collectives`: reductions that act only
  when a group is given and initialised (the JAX ``psum_if``/``pmean_if``);
* :mod:`~dissc_tpu_torch.parallel.mesh`: how a global batch is divided
  over ranks for training and split over cards for serving;
* :mod:`~dissc_tpu_torch.parallel.dryrun`: each data-parallel phase as a
  subprocess that writes rank 0's result for a caller to compare.

As in the JAX package and the reference, a config's ``batch_size`` is the
global batch and each of W ranks takes ``batch_size // W`` rows.
"""
