from repro_torch.kernels.moe_gmm.ops import moe_gmm  # noqa: F401
from repro_torch.kernels.moe_gmm.ref import moe_gmm_ref  # noqa: F401
