"""The JAX package's four examples (``examples/``), on the port: run as
``python -m repro_torch.examples.<name>`` (on ``cuda`` unless given
``--device cpu``). Each takes the JAX example's flags, sizes and seeds,
prints its lines, and its ``main(argv, model=None)`` returns the
figures it printed (``model`` replaces the seeded weights).

  * ``quickstart``: Ward factor 2 against factor 1 through ``Retriever``
    (PLAID), with nDCG@10;
  * ``build_and_search``: build, search, save, load, add and delete on
    any backend;
  * ``train_colbert``: the contrastive ``Trainer`` with checkpoints, then
    ``QualitySweep`` over the trained encoder;
  * ``multi_arch_smoke``: one loss and gradient for every assigned
    architecture.
"""
