from repro_torch.kernels.mamba_scan.ops import mamba_scan  # noqa: F401
from repro_torch.kernels.mamba_scan.ref import mamba_scan_ref  # noqa: F401
