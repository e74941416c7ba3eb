"""mpi4dl_tpu_torch — the PyTorch/CUDA port of :mod:`mpi4dl_tpu`.

Module names mirror the JAX package (``config``, ``ops.layers``,
``models.amoebanet``, ``models.resnet``, ``train`` ...). Inside, it is
PyTorch idiom: ``nn.Module``s, an explicit ``device``, explicit
``torch.Generator``s, and a ``torch.autograd.Function`` around each
hand-written CUDA kernel (``ops/csrc/*.cu``, built with nvcc for
``sm_90a`` on first use).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a GPU and without that argument they raise. On CPU tensors each
kernel wrapper runs its plain PyTorch version; on CUDA tensors it launches
the kernel or raises.

This package imports ``torch`` and never ``jax``, and nothing of
``mpi4dl_tpu``: it keeps its own copies of what it needs.
"""

__version__ = "0.1.0"



def __getattr__(name):
    # Lazy, so that the analyzers' pure-JSON subcommands import no torch.
    import importlib

    if name == "utils":
        return importlib.import_module("mpi4dl_tpu_torch.utils")
    if name == "ParallelConfig":
        return importlib.import_module("mpi4dl_tpu_torch.config").ParallelConfig
    raise AttributeError(f"module 'mpi4dl_tpu_torch' has no attribute {name!r}")
