"""Process set-up shared by the entry points (bench.py, chip_smoke.py,
scripts/): the persistent compilation cache and what the device is.

Nothing here runs at `import clsim_tpu`; entry points call it explicitly.
"""

from __future__ import annotations

import os
import subprocess

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def compile_cache_dir() -> str:
    """`JAX_COMPILATION_CACHE_DIR` when set, else `<checkout>/.jax_cache`.
    The path is fixed: it is part of the cache key, so a per-run name would
    never hit."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(CHECKOUT, ".jax_cache"))


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at compile_cache_dir() and
    return the path.  Where the environment variable is set, JAX already
    reads it; this only fills in the default."""
    import jax
    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def card_name_and_power_limit() -> str:
    """`name, power.limit` of every visible card, one line each, as
    nvidia-smi reports them; raises when nvidia-smi is missing or fails."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip()


def device_summary() -> dict:
    """platform, device_kind and device count as JAX reports them."""
    import jax
    d = jax.devices()
    return {"platform": d[0].platform, "kind": d[0].device_kind,
            "count": len(d)}
