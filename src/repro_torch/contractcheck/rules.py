"""Rule registry + finding type for the port's §9–§14 contract checker.

Every rule is one clause of the DESIGN.md bit-exactness contract, as the
port keeps it (ROADMAP, "Rules for every slice"), made machine-checkable.
``CC-*`` rules are the AST layer (`astcheck`) over the port's PyTorch
sources; ``CU-*`` rules are the CUDA layer (`cudacheck`), which reads the
kernel sources and nvcc's flags everywhere and, where the CUDA toolkit is
installed, the built SASS.  The layers share this registry so the CLI,
the config table and the findings all speak the same IDs.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

SEV_ERROR = "error"
SEV_WARNING = "warning"


@dataclasses.dataclass(frozen=True)
class Rule:
    """One contract clause: a stable ID, the layer that checks it, the
    DESIGN.md § it descends from, and the default severity."""

    rule_id: str
    layer: str        # "ast" | "cuda" | "sass", "+"-joined where two do
    origin: str       # DESIGN.md § reference
    summary: str
    severity: str = SEV_ERROR


_ALL = [
    Rule("CC-SUM", "ast", "§9",
         "backend float sum/mean reduction (torch.sum/Tensor.sum/"
         "torch.mean/torch.nansum) in a fused scope — use the pinned "
         "lane_sum/tree_sum/psum_tree halving trees (masked torch.where "
         "selects and integer/bool sums are association-free and pass)"),
    Rule("CC-SORT", "ast", "§10/§13",
         "backend sort/argsort/topk/msort in a contract scope — fused "
         "bodies use rank_desc / the bitonic network; engine-side sorts "
         "must be annotated as deliberate"),
    Rule("CC-CUMSUM", "ast", "§9",
         "backend cumulative reduction (cumsum/cumprod/cummax/cummin/"
         "logcumsumexp) in a contract scope — float prefix sums have no "
         "pinned association"),
    Rule("CC-RNG", "ast", "§9",
         "non-LCG randomness in a contract scope: stdlib random, "
         "np.random and torch's generators (torch.rand*/randn*/randint*/"
         "Generator/manual_seed/bernoulli/multinomial/Tensor.random_) "
         "anywhere, repro_torch.random inside a fused body — fused "
         "randomness goes through the shared lcg_step/lcg_mod"),
    Rule("CC-TIME", "ast", "§9",
         "clock read (time.*/datetime.now/torch.cuda.Event timing) in a "
         "contract scope — simulated time is the only clock the contract "
         "admits"),
    Rule("CC-FMA", "ast", "§9/§11",
         "multiply feeding an add/sub in one expression, or a one-call "
         "multiply-add (torch.addcmul/addcdiv/lerp/addmm/baddbmm), in a "
         "fused scope — the FMA-contraction hazard §9 (drain) and §11 "
         "(Eq. (3)) each rewrote once; clamp or split the expression"),
    Rule("CC-ASSOC", "ast", "§12",
         "association/lowering parameter (trial_tile/client_tile/shard "
         "width) resolved outside the shared resolve_client_tile/"
         "resolve_shard_width/resolve_sim_tiles resolvers"),
    Rule("CC-TILE", "ast", "§16",
         "raw read of a tile association field (cfg.trial_tile/"
         "cfg.client_tile/…) outside the shared resolvers — layers take "
         "tile shapes from the resolver/tuner surface only, so a tuned "
         "run cannot leak an unresolved tile into a launch"),
    Rule("CC-TWIN", "ast", "§8/§9",
         "xp-twin drift: the np and backend arms of an xp-branch use "
         "structurally different combining-op sets",
         severity=SEV_WARNING),
    Rule("CC-NOREASON", "ast", "§15",
         "contract-ok suppression without a reason — every deliberate "
         "deviation must say why", severity=SEV_WARNING),
    Rule("CU-SUM", "cuda+sass", "§9",
         "float accumulation in a kernel: atomicAdd/atomicAdd_block/"
         "atomicAdd_system or PTX red/atom on a float/double/half operand, "
         "a cub::/cooperative_groups:: reduce over floats, or an "
         "ATOM/ATOMS/RED carrying a float type in the built SASS — float "
         "sums go through the pinned halving tree in a fixed order"),
    Rule("CU-SORT", "cuda", "§10",
         "cub::/thrust:: sort in a kernel source — the kernels order by "
         "the all-pairs rank (rank_desc's twin), whose order is pinned"),
    Rule("CU-RNG", "cuda+sass", "§9",
         "curand* or a clock read (clock()/clock64()/%globaltimer; "
         "SR_CLOCKLO/SR_CLOCKHI/SR_GLOBALTIMER in the SASS) in a kernel — "
         "kernel randomness is the shared uint32 LCG, time is simulated"),
    Rule("CU-FAST", "cuda", "§9",
         "fast-math intrinsic (__expf/__logf/__powf/__fdividef/__sinf/"
         "__cosf/__tanf/…) or approximate PTX (.approx) in a kernel "
         "source — the plain versions round as IEEE float32 does"),
    Rule("CU-FMA", "cuda", "§9/§11",
         "explicit fused multiply-add (fmaf/fma/__fmaf_r*, PTX fma) in a "
         "kernel source, or nvcc flags without -fmad=false or with "
         "-use_fast_math/--ftz=true/-prec-div=false/-prec-sqrt=false — "
         "the plain versions never contract"),
]

RULES: Dict[str, Rule] = {r.rule_id: r for r in _ALL}


@dataclasses.dataclass
class Finding:
    """One violation: rule ID + location + message.  ``suppressed``
    findings are kept (for --show-suppressed) but never fail a run."""

    rule_id: str
    path: str
    line: int
    message: str
    severity: str = SEV_ERROR
    suppressed: bool = False
    func: Optional[str] = None

    def format(self) -> str:
        sup = " (suppressed)" if self.suppressed else ""
        where = f"{self.path}:{self.line}"
        return f"{where}: {self.rule_id} [{self.severity}]{sup} {self.message}"


def apply_severity(findings, severity_map: Dict[str, str]):
    """Stamp configured severities (config overrides registry default)."""
    for f in findings:
        rule = RULES.get(f.rule_id)
        default = rule.severity if rule else SEV_ERROR
        f.severity = severity_map.get(f.rule_id, default)
    return findings
