"""Milliseconds of the trainer's flat fp32 all-reduce of the gradients timed
alone: the program's ``all_reduce_mean_`` on a buffer of the gradients' size,
each call started once every rank has arrived, the median of five after one
that sets NCCL up (``modes/train.py:exchange_ms``). Beside
``allreduce_ms.train``, which also holds the wait for the last rank, it
separates the exchange from the ranks' lag. Nothing on one card."""


def read(record):
    return record.get("exchange_ms")
