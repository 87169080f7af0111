"""Compare render_sample-loop vs render_wave (regeneration pool) throughput."""
import sys
import time

sys.path.insert(0, ".")
import jax
import jax.numpy as jnp


def main():
    import copy
    from tests.fixtures import CBOX_JSON
    from vision_tpu.scene.scene import Scene
    from vision_tpu.integrator import pt

    RES = 512
    SPP = 16
    DEPTH = 8
    s = copy.deepcopy(CBOX_JSON)
    s["camera"]["param"]["radiance_collector"]["param"]["resolution"] = [RES, RES]
    sc = Scene(s)

    @jax.jit
    def pass_fn(frame):
        img, aovs = pt.render_sample(sc.data, sc.camera, sc.filter, frame,
                                     max_depth=DEPTH)
        return img, aovs["nrays"]

    @jax.jit
    def wave_fn(frame0):
        img, aovs = pt.render_wave(sc.data, sc.camera, sc.filter, frame0,
                                   spp=SPP, max_depth=DEPTH)
        return img, aovs["nrays"], aovs["iters"]

    # warmup
    img, nr = pass_fn(jnp.uint32(0)); img.block_until_ready()
    img2, nr2, it2 = wave_fn(0); img2.block_until_ready()

    t0 = time.perf_counter()
    tot = 0.0
    for i in range(SPP):
        img, nr = pass_fn(jnp.uint32(100 + i))
        tot += float(nr)
    img.block_until_ready()
    dt = time.perf_counter() - t0
    print(f"sample-loop: {dt*1e3:8.1f} ms  {tot/dt/1e6:8.2f} Mrays/s  ({tot:.0f} rays)")

    t0 = time.perf_counter()
    img2, nr2, it2 = wave_fn(100)
    jax.block_until_ready(img2)
    dt2 = time.perf_counter() - t0
    print(f"wave:        {dt2*1e3:8.1f} ms  {float(nr2)/dt2/1e6:8.2f} Mrays/s  "
          f"({float(nr2):.0f} rays, {int(it2)} iters)")
    # image agreement
    import numpy as np
    a = np.asarray(img)
    b = np.asarray(img2)
    print(f"wave mean={b.mean():.4f} loop-last mean={a.mean():.4f}")


if __name__ == "__main__":
    main()
