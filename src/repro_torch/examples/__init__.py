"""The paper's examples on the port, one module each: run them with
``python -m repro_torch.examples.<name> [--device cpu]`` (the card by
default).  Each ``main(device=...)`` prints what the JAX package's
``examples/<name>.py`` prints and returns its numbers."""
