"""The program's host bucketing in set-up (``_dense_shards_for`` and
``_shard_inputs``, moved to the card), on the host's clock."""


def read(run):
    return run.setup_spans.get("als_bucketing_s")
