"""Human-evaluation analysis (the reference's ``illusions_rating`` study).

``ratings`` is a copy of the JAX package's ``analysis/ratings.py`` (pandas
and scipy, no framework).  It is not imported here, so that the package
imports on a machine without pandas: ``from
evolutionary_illusion_generator_tpu_torch.analysis import ratings``.
"""
