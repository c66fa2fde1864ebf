"""Data parallelism and FSDP of the frozen backbone on `torch.distributed`:
`collectives` (the reductions and gathers on the default group, with a
byte count per kind), `mesh` (the rank's view of the data axis, the FSDP
placement rule, the rank's rows of a batch) and `launch` (one process per
rank: `torchrun`'s environment, or ranks spawned on a file store)."""
