"""Data parallelism over ranks of `torch.distributed`: the counterpart of
`hrfuser_tpu/parallel/`."""
