"""The JAX package's examples, ported: ``python -m repro_torch.examples.quickstart``
(the paper's pipeline M -> O -> S -> GU through the queue engine, flooding on
the simulator, churn), ``python -m repro_torch.examples.train_dfl`` (DFL
training, MOSGU tree all-reduce against flooding on the same data) and
``python -m repro_torch.examples.serve_batched`` (a reduced gemma2's batched
prompts and greedy decode). All run on the card unless ``--device cpu``."""
