"""Multi-process runtime, device mesh and collectives (the JAX package's
parallel/): distributed.py starts the process group, mesh.py lays the
processes out as a ('data', 'model') mesh and shards the weights over
'model', tensor.py holds the Megatron layers' collectives, collectives.py
the host-object exchange of the stage-2 prediction cache."""
