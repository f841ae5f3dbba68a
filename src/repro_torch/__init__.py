"""PyTorch / CUDA port of the paged continuous-batching serving path.

The JAX package `repro` is the reference; this package mirrors its
layout and names (`repro_torch.serve.scheduler` is the counterpart of
`repro.serve.scheduler`, and so on) so every module has an obvious
twin. It imports torch, numpy and the standard library only — never
jax and never `repro` — and keeps its own copies of the framework-free
pieces it needs (configs).

Ported so far: the dense and paged serving paths of attention decoders
(configs -> kernels -> models -> serve -> launch), with the five TPU
kernels hand-written in CUDA C++ for sm_90a (`kernels/csrc/`), the
serving telemetry (`obs/`), and the paper's own engine (`core/`: the
IMAGine ISA, the bit-exact PIM array and GEMV engine with its register
file on the card, the Gold Standard and latency models;
`launch/paper_tables.py` prints the paper's tables), training (`train/`,
`optim/`, `data/`, `ckpt/`), and the distribution layer on
`torch.distributed` (`dist/`, `launch/mesh.py`, `launch/specs.py`: the
reference's sharding rules and specs, tensor- and data-parallel
execution on each rank's blocks, the paper's reduction networks as
collectives, the int8 error-feedback all-reduce, elastic restore; ranks
are processes). Entry points run
on the card (`device="cuda"`) unless the caller passes `device="cpu"`,
where every kernel wrapper takes its plain PyTorch version.
"""
