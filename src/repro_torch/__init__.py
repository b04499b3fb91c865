"""HERMES on PyTorch and CUDA: the port of the ``repro`` package.

The paper-table path (trace → batched hierarchy engine → ``Metrics`` →
aggregates) with hand-written Hopper kernels for the set probe and the
whole-trace step.  Entry points run on the card unless the caller asks
for the CPU.  Nothing here imports jax or the ``repro`` package.
"""
