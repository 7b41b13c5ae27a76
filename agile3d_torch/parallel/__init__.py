"""The parallel paths on ``torch.distributed`` (counterpart of the JAX
package's ``parallel/``): ``mesh`` (the process groups, JAX's collectives
by name, the rank launcher), ``sp`` (the voxel-sharded decoder),
``sp_rollout`` (its device eval rollout), ``sp_backbone`` (the
halo-exchange UNet) and ``train`` (data-parallel training)."""
