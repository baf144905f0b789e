"""Machine/device info capture.

Role-equivalent of the reference's environment snapshots (run_gpu.sh:5-6
lspci/lscpu, get_info.sh:3 nvidia-smi): prints the JAX platform, device
inventory, mesh-relevant topology, and library versions so benchmark CSVs
can be attributed to hardware.

Usage: python -m hspmv.tools.info
"""

from __future__ import annotations

import platform
import sys


def collect() -> dict:
    import jax

    devices = jax.devices()
    info = {
        "jax_version": jax.__version__,
        "backend": jax.default_backend(),
        "process_count": jax.process_count(),
        "process_index": jax.process_index(),
        "device_count": len(devices),
        "local_device_count": jax.local_device_count(),
        "devices": [
            {
                "id": d.id,
                "platform": d.platform,
                "kind": getattr(d, "device_kind", "?"),
                "process": d.process_index,
            }
            for d in devices
        ],
        "python": platform.python_version(),
        "host": platform.platform(),
    }
    try:
        import numpy

        info["numpy_version"] = numpy.__version__
    except ImportError:
        pass
    from hspmv.reorder import native

    info["native_core"] = native.available()
    return info


def main(argv=None):
    del argv
    info = collect()
    for k, v in info.items():
        if k == "devices":
            for d in v:
                print(
                    f"device {d['id']}: {d['platform']} {d['kind']} "
                    f"(process {d['process']})"
                )
        else:
            print(f"{k}: {v}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
