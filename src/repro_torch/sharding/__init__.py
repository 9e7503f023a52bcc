"""Distribution on ``torch.distributed``: the partition rules and local
shards (``partition``), the collectives as autograd Functions
(``collectives``) and the GPipe pipeline (``pipeline``)."""
