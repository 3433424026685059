"""Multi-GPU training on torch.distributed: the twin of the JAX package's
parallel/ (distributed.py: the process group; mesh.py: the ('data',
'tile') mesh of ranks; shard.py: the sharded training step)."""
