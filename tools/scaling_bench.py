"""Weak-scaling benchmark across real devices (BASELINE: >=90% rays/s
efficiency 1 -> N). Run per host under the multi-host scaffold:

    python tools/scaling_bench.py [scene.json] [pixels_per_chip_side]

Prints one JSON line {dp: seconds, efficiency_vs_dp1}.
"""
import json
import sys

sys.path.insert(0, ".")


def main():
    import jax
    from vision_tpu.parallel import launch
    from vision_tpu.scene.scene import Scene

    launch.init_distributed()
    scene_path = sys.argv[1] if len(sys.argv) > 1 else None
    side = int(sys.argv[2]) if len(sys.argv) > 2 else 256

    if scene_path:
        sc = Scene(scene_path)
    else:
        import copy
        from tests.fixtures import CBOX_JSON
        sc = Scene(copy.deepcopy(CBOX_JSON))

    n = len(jax.devices())
    sizes = [d for d in (1, 2, 4, 8, 16, 32) if d <= n]
    times = launch.measure_weak_scaling(
        sc.data, sc.camera, sc.filter, dp_sizes=sizes,
        pixels_per_chip=side * side, max_depth=6, iters=4)
    base = times.get(sizes[0])
    out = {"devices": n,
           "times_s": {str(k): round(v, 4) for k, v in times.items()},
           "weak_efficiency": {str(k): round(base / v, 3)
                               for k, v in times.items() if base}}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
