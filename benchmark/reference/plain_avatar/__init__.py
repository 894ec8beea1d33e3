"""A frozen copy of the port's model modules in plain PyTorch.

The modules, parameter names and layouts are the port's, so one state_dict
loads into both; every hand-written kernel is replaced by its plain version
(ops/attention.py computes in blocks of query rows), the Winograd convs by
the direct conv and the training-only autograd Functions are left out. Run
with compute_dtype float32 and TF32 off, it is the reference the benchmark
holds the port's outputs against.
"""
