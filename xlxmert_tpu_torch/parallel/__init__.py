"""Distributed training over torch.distributed (port of xlxmert_tpu/parallel):
the process group, the mesh of ranks and the data-parallel collectives
(`mesh`), Megatron-style tensor parallelism (`sharding`), a GPipe
pipeline (`pipeline`), and the rank launcher (`launch`) that the CPU
tests and chip_smoke.py spawn their ranks with."""
