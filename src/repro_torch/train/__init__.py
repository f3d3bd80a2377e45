"""Training on one card: the train step, the checkpointer and the
fault-tolerant loop (counterpart of ``repro/train``)."""
