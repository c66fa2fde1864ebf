"""Data, tensor and sequence parallelism on `torch.distributed`:
`collectives` (the reductions and gathers on the data and model groups,
and the model axis's autograd operators, with a byte count per kind),
`mesh` (the (data x model) mesh, the FSDP and TP placements, the rank's
rows of a batch), `tensor` (the ViT's blocks on the model axis) and
`launch` (one process per rank: `torchrun`'s environment, or ranks spawned
on a file store)."""
