from repro_torch.kernels.rglru_scan.ops import rglru_scan  # noqa: F401
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref  # noqa: F401
