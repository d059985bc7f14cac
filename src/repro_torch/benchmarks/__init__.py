"""The paper's benchmark tables on the port, one module per table of the
JAX package's ``benchmarks/`` and under the same names.

    python -m repro_torch.benchmarks.run [--full] [--only NAME] \\
        [--device cuda|cpu]

Every table runs on the card unless ``--device cpu`` is given; a table
that finds no card fails, it does not carry on on the CPU.  Output lands
under ``results/bench_torch/`` (``common.BENCH_DIR``), apart from the JAX
package's ``results/bench/``.  Each module's docstring lists what it
renamed from its JAX counterpart.
"""
