"""Host codecs of the port that differ from the reference's
(:mod:`imagekit_tpu.codecs`, whose jax-free modules the port imports)."""
