"""sequitr_tpu_torch — the PyTorch/CUDA port of ``sequitr_tpu``.

The same filesystem job server, job JSON and outputs as ``sequitr_tpu``,
running on an NVIDIA Hopper card: plain tensor code is PyTorch (cuDNN for
the convolutions), and every kernel the JAX package wrote in Pallas becomes
a hand-written CUDA kernel (``sequitr_tpu_torch.ops.kernels``).

This package imports ``torch`` and never ``jax`` or ``sequitr_tpu``; host
helpers it shares with the JAX package are copies. Entry points run on the
card (``device="cuda"``) unless the caller passes ``device="cpu"``; without
a CUDA device they raise instead of quietly running on the CPU.

Every module of the JAX package has its counterpart here (the public
names are held complete by ``tests/test_torch_api_surface.py``): all 37
jobs of the JAX server, the CLI, the studies, the examples and the fixture
factory (``python -m sequitr_tpu_torch.tools.make_fixtures``).
Subpackages import lazily so ``import sequitr_tpu_torch`` stays
light.
"""

__version__ = "0.1.0"

_LAZY = (
    "client", "config", "data", "fidelity", "localize", "models", "native", "ops", "parallel",
    "pipeline", "psf", "server", "studies", "tracing", "utils",
)

__all__ = ["__version__", *_LAZY]


def __getattr__(name):
    if name in _LAZY:
        import importlib

        mod = importlib.import_module(f"sequitr_tpu_torch.{name}")
        globals()[name] = mod
        return mod
    raise AttributeError(f"module 'sequitr_tpu_torch' has no attribute {name!r}")
