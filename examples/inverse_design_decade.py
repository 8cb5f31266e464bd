"""Reference workflow 4 at full ambition: the 10-100 GHz decade sweep.

The reference INTENDED this sweep (reference: python-src/inverse_design.py:44
builds omegas over 10-100 GHz) but its code never ran (stub imports), and at
its literal units the fields underflow (see apps/inverse_design.py). Running
the decade for real requires resolving 100 GHz: dx <= lambda/10 ~ 0.3 mm on
the same 250 mm device => an ~848^2 grid, 11.5x the cells of the reference's
250^2 scene.

This drives the omega-batched differentiable FDFD stack at that scale on one
device (10 forward + 10 adjoint solves at 848^2 per value_and_grad; the
optimization loop solves at 1e-4, the reported responses at the problem's
tight tolerance) and writes: the converged low-pass frequency response of
the CONTINUOUS design, the response of its THRESHOLDED (manufacturable
binary) version, and the design images.

Run: python examples/inverse_design_decade.py [steps]
"""

import sys
import time

import numpy as np
import jax.numpy as jnp

from fdtd2d.apps.inverse_design import (binarize, decade_lowpass_problem,
                                            make_response_fn, optimize)
from fdtd2d.viz.plots import plot_frequency_response


def main(steps: int = 100):
    problem = decade_lowpass_problem(N=848, n_freqs=10, tol=1e-6, maxiter=600)
    print(f"decade sweep: N=848, dx={problem.dx*1e3:.4f} mm, "
          f"omegas {problem.omegas[0]/1e9:.0f}-{problem.omegas[-1]/1e9:.0f} GHz")

    t0 = time.perf_counter()
    step_times = []
    last = [t0]

    def cb(s, v, d):
        now = time.perf_counter()
        step_times.append(now - last[0])
        last[0] = now
        print(f"step {s}: loss {v:.6f} ({now - t0:.0f}s)", flush=True)

    design, responses, history = optimize(problem, steps=steps, lr=0.05,
                                          callback=cb, log_every=1,
                                          opt_tol=1e-4)
    per_step = (time.perf_counter() - t0) / max(steps, 1)
    print(f"final loss: {history[-1]:.6f} in {time.perf_counter()-t0:.0f}s "
          f"({per_step:.1f}s per value_and_grad incl. compile amortization)")

    r = np.asarray(responses)
    print("normalized response:", np.round(r / r.max(), 3))

    # manufacturable endpoint: threshold to binary eps in {1, 3} and
    # re-evaluate at the tight tolerance
    bdesign = binarize(design)
    responses_b, _ = make_response_fn(problem)
    rb = np.asarray(responses_b(jnp.asarray(bdesign)))
    print("binarized response: ", np.round(rb / rb.max(), 3))

    plot_frequency_response(problem.omegas, r,
                            np.asarray(problem.ideal_response),
                            "frequency_response_decade.png")
    plot_frequency_response(problem.omegas, rb,
                            np.asarray(problem.ideal_response),
                            "frequency_response_decade_binary.png")
    np.save("design_decade.npy", np.asarray(design))
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, (a1, a2) = plt.subplots(1, 2, figsize=(10, 5))
    a1.imshow(np.asarray(design), cmap="viridis", vmin=1.0, vmax=3.0)
    a1.set_title("continuous design (rel. eps)")
    a2.imshow(np.asarray(bdesign), cmap="viridis", vmin=1.0, vmax=3.0)
    a2.set_title("thresholded design")
    for a in (a1, a2):
        a.axis("off")
    plt.savefig("design_decade.png", dpi=150, bbox_inches="tight")
    print("wrote frequency_response_decade.png, "
          "frequency_response_decade_binary.png, design_decade.png")


if __name__ == "__main__":
    from fdtd2d.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 100)
