from repro_torch.kernels.rotor_slice.ops import rotor_slice_step  # noqa: F401
