"""Training of the dense LM: AdamW with float32 master weights
(``optimizer``), the microbatched train step (``steps``) and the
fault-tolerant loop with checkpoints (``trainer``)."""
