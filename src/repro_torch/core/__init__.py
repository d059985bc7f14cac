"""Generation core: sampler engine, R-MAT, features, aligner, pipeline."""
