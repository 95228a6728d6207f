"""The JAX package's side of tests/test_torch_sharding.py's sharded runs
(a helper process, not a test module).

``python tests/torch_sharding_reference.py OUT ARCH`` runs the JAX
package's sharded train step for ARCH on tests/torch_sharding_worker.py's
meshes (its mesh built with ``repro.compat.make_mesh`` under four forced
host devices, jitted with ``state_shardings``, under ``use_mesh_rules``)
from its own ``init_state(jax.random.key(0))`` and the batch in
``OUT/batch.npz``, and, for the first arch of ``ARCHS``, its
``compressed_psum`` under ``shard_map`` on meshes of 2 and 4 devices;
the metrics, the parameters and the second moments v go to
``OUT/reference-ARCH.npz``.  The test runs one process an arch, at
once.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_sharding_worker import (ARCHS, MESHES, PSUM_WORLDS,  # noqa: E402
                                   ROOT, STEP_OPT, case_fields, mesh_dims,
                                   psum_inputs)


def main(out: str, arch: str) -> None:
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.compat import make_mesh, shard_map, simple_keystr
    from repro.configs import get_config
    from repro.launch.shardutil import state_shardings
    from repro.parallel import sharding as PS
    from repro.train import OptConfig, compression as C, init_state, \
        make_train_step

    assert jax.device_count() == 4
    batch = {k: jnp.asarray(v) for k, v in
             np.load(os.path.join(out, "batch.npz")).items()}
    saved = {}
    for spec in MESHES:
        dims = mesh_dims(spec)
        names = ("data", "model")[:len(dims)]
        mesh = make_mesh(dims, names)
        rules = PS.make_rules(mesh)
        cfg = case_fields(get_config(arch, reduced=True))
        state = init_state(jax.random.key(0), cfg)
        st_sh = state_shardings(jax.eval_shape(lambda: state), rules)
        state = jax.device_put(state, st_sh)
        step = jax.jit(make_train_step(cfg, OptConfig(**STEP_OPT)),
                       in_shardings=(st_sh, None),
                       out_shardings=(st_sh, None))
        with mesh, PS.use_mesh_rules(rules):
            state, metrics = step(state, batch)
        key = f"{spec}/{arch}"
        for k, v in metrics.items():
            saved[f"{key}/metrics/{k}"] = np.asarray(v)
        for part, tree in (("params", state.params),
                           ("v", state.opt.v)):
            for kp, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
                saved[f"{key}/{part}/{simple_keystr(kp)}"] = \
                    np.asarray(v)
    for n in PSUM_WORLDS if arch == ARCHS[0] else ():
        mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:n]), ("data",))

        def both(g, e):
            ef = C.EFState(residual=e)
            mean, ef = C.compressed_psum(g, ef, "data")
            return mean, ef.residual

        fm = jax.jit(shard_map(both, mesh=mesh, in_specs=(P("data"),) * 2,
                               out_specs=(P("data"),) * 2))
        e = None
        for round_ in (0, 1):
            g = {k: jnp.concatenate([jnp.asarray(psum_inputs(r, round_)[k])
                                     for r in range(n)])
                 for k in psum_inputs(0, 0)}
            e = C.init_ef(g).residual if e is None else e
            mean, e = fm(g, e)
            for k in g:
                saved[f"psum{n}/{round_}/mean/{k}"] = np.asarray(mean[k])
                saved[f"psum{n}/{round_}/residual/{k}"] = np.asarray(e[k])
    np.savez(os.path.join(out, f"reference-{arch}.npz"), **saved)


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(ROOT, "src"))
    main(sys.argv[1], sys.argv[2])
