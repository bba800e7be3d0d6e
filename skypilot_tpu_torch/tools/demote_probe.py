"""Does a saturated demote queue keep the hot prefix chains?

    python -m skypilot_tpu_torch.tools.demote_probe [--delay-s 0.5] [--runs 2]

Run from the repo's root: it drives ``chip_smoke.py``'s phase 11 P2
(llama3-1b at ``chip_smoke.RECIPE_LAYERS`` layers, int8 weights and KV,
256 usable blocks of 16, a host tier of about two chains and a spill
directory; round 1 the recipe window, round 2 8 new preambles, round 3
the first 4 preambles again) with the tier worker slowed by
``--delay-s`` before each demote job, so the queue saturates as on a
loaded host. Each run goes once with the old admission rule (every chain
refused at ``_DEMOTE_QUEUE_MAX``, ``_HOT_HEADROOM`` 1) and once with the
shipped one, and prints per round the evictions, share hits and tier
counters, and whether P2's checks held (round 3 promotes or fetches).

Needs one CUDA card; numbers are for the card named on the first line.
"""
from __future__ import annotations

import argparse
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--delay-s', type=float, default=0.5)
    ap.add_argument('--runs', type=int, default=2)
    args = ap.parse_args(argv)

    import chip_smoke as cs
    from skypilot_tpu_torch.models import generate as gen_lib
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.ops import decode_attention as da
    from skypilot_tpu_torch.serve import kv_tiers
    from skypilot_tpu_torch.serve import llm_server as srv_lib
    from skypilot_tpu_torch.utils.device import resolve_device

    print(cs._card(), flush=True)  # noqa: SLF001
    resolve_device()
    cs._build_all([da])  # noqa: SLF001
    drain, shipped = kv_tiers.KVTiers._drain_demote, kv_tiers._HOT_HEADROOM  # noqa: SLF001

    def slow(self, job):
        time.sleep(args.delay_s)
        drain(self, job)
    kv_tiers.KVTiers._drain_demote = slow  # noqa: SLF001
    held = 0
    try:
        with cs._cut_depth(llama, 'llama3-1b', cs.RECIPE_LAYERS):  # noqa: SLF001
            for _ in range(args.runs):
                for rule, headroom in (('old', 1), ('shipped', shipped)):
                    kv_tiers._HOT_HEADROOM = headroom  # noqa: SLF001
                    try:
                        figs = cs._paged_p2(srv_lib, gen_lib, da)[0]  # noqa: SLF001
                        verdict = 'checks held'
                        held += rule == 'shipped'
                    except AssertionError as e:
                        figs, verdict = {}, f'checks failed: {e}'
                    print(f'{rule} rule (headroom {headroom}), worker '
                          f'delay {args.delay_s} s: {verdict}', flush=True)
                    for name, fig in figs.items():
                        print(f'  {name}: evictions {fig["evictions"]}, '
                              f'share hits {fig["share_hits"]}, tiers '
                              f'{fig["tiers"]}', flush=True)
    finally:
        kv_tiers.KVTiers._drain_demote = drain  # noqa: SLF001
        kv_tiers._HOT_HEADROOM = shipped  # noqa: SLF001
    return 0 if held == args.runs else 1


if __name__ == '__main__':
    raise SystemExit(main())
