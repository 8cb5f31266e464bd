"""FDTD backends A/B on one GPU: the XLA step against the K-step CUDA kernel.

For each grid size, in one process and in turns (jax, kstep, kstep, jax),
times ``fdtd2d.fdtd.simulate`` on the bench scene (bench.py) with the
fields already on the device: best of 3 runs, each ended by
``jax.block_until_ready``. Prints one JSON line per size with both rates
and the card's name and power limit.

Usage: python examples/fdtd_backend_ab.py [N ...]   (default 256 .. 8192)
"""

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from fdtd2d import constants
    from fdtd2d.fdtd.simulate import FDTDConfig, simulate

    if jax.devices()[0].platform != "gpu":
        raise SystemExit("no GPU found")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    sizes = [int(a) for a in sys.argv[1:]] or [256, 512, 1024, 2048, 4096, 8192]
    for N in sizes:
        steps = int(min(max(4e9 / N**2, 120), 20000)) // 12 * 12
        eps = np.full((N, N), constants.EPSILON_0, np.float32)
        eps[N // 4 : N // 2, N // 4 : N // 3] *= 4.0
        eps = jnp.asarray(eps)
        mu = jnp.full((N, N), constants.MU_0, jnp.float32)
        rates = {"jax": [], "kstep": []}
        states = {}
        for backend in ("jax", "kstep", "kstep", "jax"):
            cfg = FDTDConfig(dt=5e-14, dx=1e-4, nsteps=steps,
                             source_xy=(N // 2, N // 2), source_fc=30e9,
                             backend=backend)
            if backend not in states:
                states[backend] = jax.block_until_ready(simulate(eps, mu, cfg)[0])
            best = float("inf")
            for _ in range(3):
                t0 = time.perf_counter()
                states[backend] = jax.block_until_ready(
                    simulate(eps, mu, cfg, state=states[backend])[0])
                best = min(best, time.perf_counter() - t0)
            rates[backend].append(N * N * steps / best / 1e9)
        print(json.dumps({"N": N, "steps": steps, "gcells_jax": rates["jax"],
                          "gcells_kstep": rates["kstep"], "card": card,
                          "device_kind": jax.devices()[0].device_kind}),
              flush=True)


if __name__ == "__main__":
    main()
