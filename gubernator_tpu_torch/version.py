"""The release version (the port ships with the JAX package's release)."""

VERSION = "0.2.0"


def banner() -> str:
    """The startup identification line (cmd/gubernator/main.go:53)."""
    import platform

    import torch

    return (
        f"gubernator-tpu-torch {VERSION} "
        f"(python {platform.python_version()}/{platform.machine()}, "
        f"torch {torch.__version__}, cuda {torch.version.cuda})"
    )
