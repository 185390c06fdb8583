"""repro_torch — the PyTorch and CUDA port of the scDataset reproduction.

A package beside the JAX package ``repro``, which stays the reference: it
keeps ``repro``'s module names, imports nothing of it (nor of JAX), and is
held against it by the tests ``tests/test_torch_*.py``.  Its entry points
run on the CUDA card unless the caller passes ``device="cpu"``.

Ported so far, three slices.  The paper's cell-training path:

- ``core``: sampling strategies, callbacks, ``ScIterableDataset`` (a
  ``torch.utils.data.IterableDataset``) and ``LoaderState``;
- ``data``: the sharded on-disk CSR store, its I/O counters and the
  Tahoe-like generator;
- ``kernels``: ``ell_to_dense``, a hand-written Hopper kernel
  (``kernels/csrc/ell_to_dense.cu``) with an optional fused ``log1p``, its
  plain version and the dispatch;
- ``distributed.dataio``: the two-deep host-to-device feed;
- ``train.probe``: the four linear heads and their Adam step;
- ``convert``: JAX heads and Adam state as the port's.

LM serving (``models``, ``configs``, ``serve.scheduler``,
``launch.serve``) of the dense, moe and ssm families, seven of the
reference's ten configs, with the ``flash_attention`` kernels and the
``ssm_scan`` Hopper kernel, and LM training (``launch.train``: the ``tokens://`` ``pipeline``
over ``data.tokens``, ``train.loss``, ``train.optimizer``, ``train.step``,
``checkpoint``, ``distributed.fault``) with the forward-with-lse, dq and
dk/dv Hopper kernels under ``kernels.flash_attention_bwd``.
"""
