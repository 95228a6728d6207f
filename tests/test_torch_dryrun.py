"""The port's dry run (`repro_torch.launch.dryrun`) against the JAX
package's (`repro.launch.dryrun`), where both compute the same quantity:

* ``params`` (the parameter tensors' elements) and `model_flops_for` for
  every arch x shape, the skips and their reasons;
* the ring wire model (`dryrun.ring_wire`) against the JAX
  ``parse_collectives`` fed one synthetic HLO line per collective kind at
  group sizes 1, 2, 16 and 256, in both ``replica_groups`` forms;
* the perf variants: the same overrides of every configuration field
  and rule;
* in a fake world of four (tests/torch_dryrun_worker.py, a process of
  its own: the fake world must not reach this process's other tests),
  the sharded train step's traced matmul FLOPs a rank equal to the
  unsharded `make_train_step` on one batch slice, for the reduced
  gemma-2b and the reduced mixtral-8x22b (local pools); the collectives
  `dryrun._CostMode` records; `start_world`'s refusal of a process with
  another default group;
* the CLI on production cells of the 16 x 16 mesh (gemma-2b ``train_4k``
  and ``decode_32k``, in a process of its own): status ``ok``, and the
  state's part of ``argument_bytes`` (the train state's; the serve
  cell's parameters) equal to the sum over the JAX package's
  ``param_specs`` on the same mesh shape of each leaf's local bytes.
  The batch and the caches are left out of that comparison: a port rank
  is handed the global batch and holds its rows' caches whole.

Importing ``repro.launch.dryrun`` prepends 512 forced host devices to
``XLA_FLAGS``; the devices are initialised first (``jax.devices()``) and
the variable is restored after the import.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest

from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.configs import shape_applies as jax_shape_applies
from repro.parallel import sharding as JPS
from repro.train.steps import abstract_state as jax_abstract_state
from repro_torch.configs import ARCH_IDS, SHAPES, get_config, shape_applies
from repro_torch.launch import dryrun as D
from repro_torch.parallel import sharding as PS
from repro_torch.train import abstract_state
from torch_jax_release import release_compiled_programs  # noqa: F401

jax.devices()
_FLAGS = os.environ.get("XLA_FLAGS")
import repro.launch.dryrun as JD  # noqa: E402

if _FLAGS is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _FLAGS

ROOT = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).resolve().parent / "torch_dryrun_worker.py"
TIMEOUT = 240  # seconds, for each spawned process
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")


def _env():
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + [p for p in [os.environ.get("PYTHONPATH")]
                               if p]))


def _run(cmd):
    proc = subprocess.run(cmd, env=_env(), capture_output=True, text=True,
                          timeout=TIMEOUT, cwd=ROOT)
    assert proc.returncode == 0, (proc.stdout[-3000:], proc.stderr[-3000:])
    return proc


@pytest.mark.parametrize("arch", JAX_ARCH_IDS)
def test_params_and_model_flops_match_jax(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    params = sum(t.numel() for t in
                 abstract_state(cfg).params.state_dict().values())
    want = sum(int(np.prod(l.shape))
               for l in jax.tree.leaves(jax_abstract_state(jcfg).params))
    assert params == want
    for name, shape in SHAPES.items():
        js = JAX_SHAPES[name]
        assert D.model_flops_for(cfg, shape.kind, shape.global_batch,
                                 shape.seq_len, params) == \
            JD.model_flops_for(jcfg, js.kind, js.global_batch, js.seq_len,
                               want), name


def test_skips_match_jax():
    assert sorted(ARCH_IDS) == sorted(JAX_ARCH_IDS)
    assert list(SHAPES) == list(JAX_SHAPES)
    for arch in ARCH_IDS:
        for name in SHAPES:
            got = shape_applies(get_config(arch), SHAPES[name])
            assert got == jax_shape_applies(jax_get_config(arch),
                                            JAX_SHAPES[name]), (arch, name)
            rec = D.lower_cell(arch, name, False) if not got[0] else None
            if rec is not None:
                assert rec == {"arch": arch, "shape": name, "mesh": "16x16",
                               "tag": "", "status": "skip",
                               "reason": got[1]}


def _hlo(kind: str, n: int, iota: bool) -> str:
    """One partitioned-HLO line of ``kind`` with a bf16 (64, 128) result
    over groups of ``n`` (an iota or a listed ``replica_groups``)."""
    groups = (f"replica_groups=[{512 // n},{n}]<=[512]" if iota else
              "replica_groups={{" + ",".join(map(str, range(n))) + "}}")
    return (f"  %c.{n} = bf16[64,128]{{1,0}} {kind}(bf16[64,128]{{1,0}} "
            f"%p), channel_id=1, {groups}, use_global_device_ids=true")


@pytest.mark.parametrize("kind", KINDS)
def test_wire_model_matches_parse_collectives(kind):
    """The JAX dry run's ``parse_collectives`` of one synthetic line a
    group size and form against `ring_wire` of its 16,384 bytes."""
    for n in (1, 2, 16, 256):
        for iota in (False, True):
            want = JD.parse_collectives(_hlo(kind, n, iota))
            assert want["raw_bytes"] == {kind: 64 * 128 * 2}
            assert want["n_ops"] == 1
            assert D.ring_wire(kind, 64 * 128 * 2, n) == \
                want["wire_bytes"], (n, iota)


def test_variants_match_jax():
    """Every variant overrides the same configuration fields and rules."""
    assert list(D.VARIANTS) == list(JD.VARIANTS)
    rules = PS.make_rules(PS.MeshShape(("data", "model"), (16, 16)))
    jrules = JPS.make_rules(SimpleNamespace(
        axis_names=("data", "model"), shape={"data": 16, "model": 16}))
    for tag in D.VARIANTS:
        for arch in ARCH_IDS:
            cfg, jcfg = get_config(arch), jax_get_config(arch)
            try:
                want_cfg, want_rules = JD.VARIANTS[tag](jcfg, jrules)
            except AssertionError:
                with pytest.raises(AssertionError):
                    D.VARIANTS[tag](cfg, rules)
                continue
            got_cfg, got_rules = D.VARIANTS[tag](cfg, rules)
            assert dataclasses.asdict(got_cfg) == \
                dataclasses.asdict(want_cfg), (tag, arch)
            for f in ("batch_axes", "fsdp_axis", "tp_axis", "seq_axis"):
                assert getattr(got_rules, f) == getattr(want_rules, f)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun_world4") / "out.json"
    _run([sys.executable, str(WORKER), str(out)])
    return json.loads(out.read_text())


@pytest.mark.parametrize("arch", ("gemma-2b", "mixtral-8x22b"))
def test_sharded_flops_equal_unsharded_slice(world4, arch):
    got = world4[arch]
    assert got["rows"] == 2 and got["n_coll"] > 0
    assert got["sharded"] == got["unsharded"] > 0


def test_collectives_counted_with_their_groups(world4):
    """On the (2, 2) mesh of a world of four: an all-reduce and an
    all-gather of a (6, 10) float32 on each dimension, with the group's
    global ranks, and the ring model's wire bytes."""
    assert world4["coll"] == [["all-reduce", 240, [0, 2]],
                              ["all-gather", 480, [0, 2]],
                              ["all-reduce", 240, [0, 1]],
                              ["all-gather", 480, [0, 1]]]
    s = world4["summary"]
    assert s["raw_bytes"] == {"all-reduce": 480, "all-gather": 960}
    assert s["wire_bytes"] == 2 * (2 * 240 / 2 + 480 / 2) and s["n_ops"] == 4
    # both groups sit inside one node: the NVLink rate
    assert s["collective_s"] == pytest.approx(960 / D.NVLINK_BW)
    assert "already has a default group" in world4["refusal"]


@pytest.fixture(scope="module")
def production(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun_cli") / "cells.json"
    _run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
          "gemma-2b", "--shape", "train_4k,decode_32k", "--mesh", "16x16",
          "--out", str(out)])
    return {r["shape"]: r for r in json.loads(out.read_text())}


def test_cli_production_cells_ok(production):
    for name in ("train_4k", "decode_32k"):
        rec = production[name]
        assert rec["status"] == "ok" and rec["n_devices"] == 256, rec
        assert rec["inner_scan_corr_flops"] == 0.0
        assert rec["cost_source"] == "full-depth trace"
        mem, roof = rec["memory"], rec["roofline"]
        assert mem["peak_per_device_bytes"] >= mem["argument_bytes"] > 0
        assert roof["dominant"] in ("compute_s", "memory_s", "collective_s")
        assert rec["cost"]["flops_per_dev"] > 0
    # the port replicates compute along "model": a rank computes its data
    # slice's whole width (16 rows of 256), remat adding a forward pass
    useful = production["train_4k"]["roofline"]["useful_flops_ratio"]
    assert 1 / 32 < useful < 1 / 16


def _jax_state_bytes(arch: str, train: bool) -> int:
    """The JAX package's train state (or parameters) on the 16 x 16 mesh:
    each leaf's local bytes under ``param_specs`` (m and v as their
    parameters, the counters replicated)."""
    jcfg = jax_get_config(arch)
    rules = JPS.make_rules(SimpleNamespace(
        axis_names=("data", "model"), shape={"data": 16, "model": 16}))
    state = jax_abstract_state(jcfg)
    specs = JPS.param_specs(state.params, rules)
    leaves = jax.tree.leaves(state.params)
    spec_leaves = jax.tree.leaves(specs, is_leaf=lambda s: isinstance(
        s, jax.sharding.PartitionSpec))
    params = sum(JPS.spec_bytes_per_device(l.shape, l.dtype, s, rules)
                 for l, s in zip(leaves, spec_leaves, strict=True))
    if not train:
        return params
    moments = sum(JPS.spec_bytes_per_device(l.shape, np.float32, s, rules)
                  for l, s in zip(leaves, spec_leaves, strict=True))
    return params + 2 * moments + 2 * 4   # + opt.count and step, int32


def test_state_argument_bytes_match_jax_specs(production):
    parts = production["train_4k"]["memory"]["argument_parts"]
    assert parts["state"] == _jax_state_bytes("gemma-2b", True)
    parts = production["decode_32k"]["memory"]["argument_parts"]
    assert parts["params"] == _jax_state_bytes("gemma-2b", False)
    # the caches under the reference's roles (sequence on "model") beside
    # what the port holds (its 8 rows' caches whole): 16x apart
    mem = production["decode_32k"]["memory"]
    assert parts["caches"] == 16 * mem["caches_bytes_by_roles"]
