"""Microbenchmark drivers of the port (counterparts of experiments/ in the
JAX package's repository), each run as `python -m
aqp_tpu_torch.experiments.<name>`: on the CUDA card by default, on the CPU
with `--device cpu` (where the kernels' plain versions run)."""
