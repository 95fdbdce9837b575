"""The card a measurement runs on: its identity, and its published
peaks keyed by JAX's device_kind.

Peaks are NVIDIA's data-sheet figures for the H100 SXM (dense, no
sparsity, at the full 700 W power limit). A device that is not in the
table is an error, not a default.
"""

import subprocess

PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_bytes_per_s": 3.35e12,
        "fp32_flops": 67e12,
        "tf32_flops": 495e12,
    },
}


def require_gpu() -> dict:
    """JAX's first device must be a GPU. Returns {platform, kind, count,
    gpu}: gpu is nvidia-smi's 'name, power.limit' line."""
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX platform is {devs[0].platform!r}")
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs), "gpu": r.stdout.strip().splitlines()[0]}


def peaks(kind: str) -> dict:
    try:
        return PEAKS[kind]
    except KeyError:
        raise KeyError(f"no published peaks for device kind {kind!r}"
                       ) from None
