"""Distribution over ``torch.distributed``: the sharding rules engine, the
int8 compressed all-reduce, ring attention and the GPipe pipeline."""
