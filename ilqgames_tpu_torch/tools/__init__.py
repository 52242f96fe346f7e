"""Probes of the port's kernels on the card: the counterparts of the JAX
package's TPU probes under tools/ (see `_probe` for what they share).

    python3 -m ilqgames_tpu_torch.tools.kernel_floor
    python3 -m ilqgames_tpu_torch.tools.sweep_floor
    python3 -m ilqgames_tpu_torch.tools.kernel_profile
    python3 -m ilqgames_tpu_torch.tools.profile_components

Each prints one JSON line per case and needs a CUDA device. Beside them,
`trip_profile` (no TPU counterpart) times trips 10-19 of the queue cell
and traces them under torch.profiler:

    python3 -m ilqgames_tpu_torch.tools.trip_profile
"""
