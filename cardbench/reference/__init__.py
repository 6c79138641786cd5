"""The benchmark's plain reference: the two model families, the DFL step
around them and the gossip wire, in plain PyTorch (float32, TF32 off).

Nothing here imports the program (``repro_torch``), ``repro`` or JAX: a
test under ``cardbench/tests`` checks it module by module.
"""
