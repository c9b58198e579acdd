"""The port's distributed layer on ``torch.distributed``: the k-means mesh
and its row-block layouts (``sharding``), the one helper every collective
goes through (``comm``), int8 error-feedback compression (``compress``),
and the process world the tests and ``chip_smoke.py`` start (``world``).

NCCL runs across cards and gloo on the CPU; a gloo world on a card stages
every collective through host memory (``comm``).  Nothing here starts a
process or a group when it is imported.
"""
