"""The plain fp32 reference that decides whether a run is correct.

`plain_avatar` is a frozen copy of the port's modules with every kernel
replaced by plain PyTorch; `entry` builds it and runs the two entries the
cells time. Nothing here imports the port, JAX or the JAX package.
"""
