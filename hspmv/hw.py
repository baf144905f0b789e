"""Published peaks of the cards this program runs on, keyed on
``jax.devices()[0].device_kind``.

The reference encodes per-architecture knowledge in Makefile targets and
per-arch tuning binaries (spmv-csrk/Makefile:17-30, cuda-spmv-csrk/cuda/
spmv-auto-{volta,ampere}.cu); here one table serves the roofline
reporting, the cold-regime sizing and the scaling model. A kind that is
not in the table is an error, never a default.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class DeviceSpec:
    kind: str  # device_kind as JAX reports it (table key)
    hbm_bytes_per_s: float  # published device-memory bandwidth
    hbm_bytes: int  # device memory capacity
    l2_bytes: int  # L2 cache capacity
    smem_per_block_bytes: int  # shared memory one block can use
    link_bytes_per_s: float  # NVLink to the host's other cards, each way
    source: str


_H100_SXM = DeviceSpec(
    kind="NVIDIA H100 80GB HBM3",
    hbm_bytes_per_s=3.35e12,
    hbm_bytes=80 * 10**9,
    l2_bytes=50 * 2**20,
    smem_per_block_bytes=227 * 2**10,
    link_bytes_per_s=450e9,
    source="NVIDIA H100 Tensor Core GPU datasheet (SXM5); NVIDIA Hopper "
    "architecture whitepaper",
)

_SPECS = {s.kind: s for s in (_H100_SXM,)}


def spec_for_kind(kind: str) -> DeviceSpec:
    """The table row for a device_kind string; ValueError if absent."""
    try:
        return _SPECS[kind]
    except KeyError:
        raise ValueError(
            f"no published peaks for device kind {kind!r}; known: "
            + ", ".join(sorted(_SPECS))
        ) from None


def device_spec() -> DeviceSpec:
    """Spec of the process's first device (raises for unknown kinds)."""
    import jax

    return spec_for_kind(jax.devices()[0].device_kind)


def nvidia_smi() -> str:
    """`name, power.limit` of the first card, from nvidia-smi run in a
    child process (which does not touch JAX)."""
    import subprocess

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    return out.splitlines()[0]


def card_label() -> str:
    """Platform, device kind, device count, name and power limit: the
    label every printed rate carries."""
    import jax

    d = jax.devices()[0]
    return (
        f"{d.platform} {d.device_kind} x{len(jax.devices())} "
        f"[{nvidia_smi()}]"
    )
