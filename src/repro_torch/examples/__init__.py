"""The JAX package's examples, ported: ``python -m repro_torch.examples.quickstart``
(the paper's pipeline M -> O -> S -> GU through the queue engine, flooding on
the simulator, churn), ``python -m repro_torch.examples.train_dfl`` (DFL
training, MOSGU tree all-reduce against flooding on the same data),
``python -m repro_torch.examples.serve_batched`` (a reduced gemma2's batched
prompts and greedy decode) and ``python -m
repro_torch.examples.topology_playground`` (MST + coloring across the graph
families, the protocol matrix, the scenario, sweep and underlay front
doors). All run on the card unless ``--device cpu``."""
