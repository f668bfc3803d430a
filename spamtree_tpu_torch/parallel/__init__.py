"""Multi-device sampling over ``torch.distributed`` (counterpart of
``spamtree_tpu/parallel``): ``mesh`` (the chains x blocks process groups
and their collectives), ``sharding`` (block shards of a model) and
``launch`` / ``worker`` (one process per device for ``spamtree(devices=)``)."""
