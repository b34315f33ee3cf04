"""Spatial (sp) and data (dp) parallelism over torch.distributed process
groups (counterpart of sps_tpu/parallel/): `comm` holds the collectives, one
process group per mesh axis; `spatial` slices a replicated topology pyramid
to a rank's block of every level; `mesh` builds the dp x sp layout and the
data-parallel training step; `launch` spawns one process per rank."""
