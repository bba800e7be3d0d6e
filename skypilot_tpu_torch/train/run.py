"""Training entry point: ``python -m skypilot_tpu_torch.train.run``.

Port of ``skypilot_tpu/train/run.py``, e.g. BENCH_1B at seq 4096 on one
H100:

    python -m skypilot_tpu_torch.train.run --model bench-1b --seq-len 4096 \\
        --global-batch-size 2 --steps 20 --log-every 5

or the repo's flagship recipe (``examples/llama_finetune.yaml``), which
resumes from the newest durable step when it is relaunched:

    python -m skypilot_tpu_torch.train.run --model llama3-1b --steps 2000 \\
        --global-batch-size 8 --seq-len 2048 --ckpt-dir /ckpt --save-every 50

or the LoRA recipe (``examples/llm/lora-finetune/lora_finetune.yaml``):

    python -m skypilot_tpu_torch.train.run --model bench-1b \\
        --global-batch-size 16 --seq-len 2048 --mesh fsdp=-1 \\
        --lora-rank 16 --lora-alpha 32 --lora-targets wq,wk,wv,wo \\
        --ckpt-dir /ckpt --save-every 50

or the multislice recipe (``examples/llm/multislice-train/train.yaml``)
on each host process under the gang launcher's env
(``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``,
``MEGASCALE_NUM_SLICES``):

    python -m skypilot_tpu_torch.train.run --model bench-1b --steps 500 \
        --global-batch-size 32 --seq-len 2048 --mesh "data=2,fsdp=-1"

It takes the original's model, batch, optimizer, data, remat and
checkpoint flags (``--ckpt-dir``, ``--ckpt-local-dir``, ``--ckpt-sync``,
``--save-every``, ``--step-time-floor``), plus ``--warmup-steps`` and
``--device`` (CUDA unless ``cpu``). Checkpoints are the JAX package's
format (``ckpt/``), so a run of either package resumes from the other's.
On SIGTERM it persists the freshest snapshot, dumps a ``sigterm``
incident bundle (``observability/blackbox.py``) and exits 143. LoRA
(``--lora-rank``, ``--lora-alpha``, ``--lora-targets``) trains adapters
over a frozen base.

``--mesh`` and ``--num-slices`` (default ``MEGASCALE_NUM_SLICES``, else
1; the default spec ``data={num_slices},fsdp=-1``) train on a mesh of
ranks, one process per rank (``parallel/gang.py``): each host process
starts its share of the ranks, spawning ``python -m
skypilot_tpu_torch.train.run`` with its own argv for the others. A ``-1``
axis resolves against the gang's cards (``JAX_NUM_PROCESSES`` times the
host's cards; one per host on the CPU), as JAX resolves it against its
devices, so ``fsdp=-1`` on a one-card host is one device and trains as
before; an explicit spec may place several ranks on one card, whose
collectives then go through gloo, staged through the host. Rank 0 prints
JAX's ``[train] mesh {...} over N slice(s)`` line. Every rank draws the
global synthetic batch of step i (seed i) and keeps its rows, so a mesh
trains on the one-device run's tokens. A spec that does not divide the
ranks raises JAX's ``ValueError``; the axes not ported yet (``pipe``,
``seq``, ``expert``) exit with code 2, each by name. Under a mesh every
rank prints a ``[train] rank-summary {json}`` line at the end (losses,
``grad_norm``, kernel launches, weight bytes, peak memory, collectives),
and SIGTERM reaches every rank of a host: the host's first rank persists
(with ``--ckpt-dir``) and every rank exits 143. Every ``--log-every``
steps it prints
``[train] step i/N loss=...`` as the original does, with the window's
step ms, tokens/s, and model FLOP/s as a share of the card's dense bf16
peak (989 TFLOP/s, an H100 SXM at 700 W) beside the card's name, and
appends a window record to the telemetry spool when
``SKYTPU_TRAIN_TELEMETRY_DIR`` is set. The model FLOPs are 6 x
``param_count`` x tokens, as the JAX package counts them: for an MoE
model (``--model moe-8x1b``) that counts every expert, so the start line
also prints the share of the parameters a token runs through, and each
step line the balance loss ``moe_aux``. ``main`` returns the losses (and
an MoE model's ``moe_aux``) of the steps it ran and the final state, so a
script can drive it in-process (one device).
"""
from __future__ import annotations

import argparse
import copy
import json
import os
import signal
import sys
import time
from typing import Any, Dict, List, Optional

import torch

from skypilot_tpu_torch.utils.device import H100_BF16_DENSE_FLOPS


def make_sigterm_handler(mgr):
    """The preemption SIGTERM handler: emergency-persist FIRST (the
    checkpoint write races the SIGKILL escalation deadline and must not
    wait on a bundle), one line on stderr with the durable step and the
    seconds the persist took, THEN freeze the flight recorder's ring into
    a ``sigterm`` incident bundle (the ``ckpt.*`` edges and the thread
    stacks: where the trainer was when the preemption landed), THEN exit
    143, as the JAX handler does."""
    from skypilot_tpu_torch.observability import blackbox

    def _on_sigterm(signum, frame):
        del signum, frame
        t0 = time.perf_counter()
        step = mgr.emergency_persist()
        # os.write, not print: the signal may land inside a print of the
        # step loop, and a buffered stream refuses a reentrant write.
        os.write(2, f'[train] SIGTERM: emergency persist returned step '
                    f'{step} in {time.perf_counter() - t0:.3f} s\n'.encode())
        blackbox.dump('sigterm', reason='trainer preemption')
        raise SystemExit(143)

    return _on_sigterm


def make_gang_sigterm_handler(mgr, gang):
    """SIGTERM on a rank of a training gang: a host's first rank hands the
    signal to the ranks it spawned, persists the freshest snapshot (with
    a checkpoint manager) and dumps the bundle, then every rank exits 143
    at once: its peers are leaving, so no collective, and no teardown of
    the process groups, may run after it."""
    from skypilot_tpu_torch.observability import blackbox

    def _on_sigterm(signum, frame):
        del frame
        gang.forward_signal(signum)
        if mgr is not None and mgr.writer:
            t0 = time.perf_counter()
            step = mgr.emergency_persist()
            os.write(2, f'[train] SIGTERM: rank {gang.rank} emergency '
                        f'persist returned step {step} in '
                        f'{time.perf_counter() - t0:.3f} s\n'.encode())
            blackbox.dump('sigterm', reason='trainer preemption')
        if gang.children:
            codes = gang.release_children(30.0)
            os.write(2, f'[train] SIGTERM: rank {gang.rank}: ranks spawned '
                        f'here exited with {codes}\n'.encode())
        os._exit(143)

    return _on_sigterm


def exit_on_sigterm_from_a_thread() -> None:
    """A rank with nothing to persist and no ranks of its own exits 143 on
    SIGTERM even inside a collective whose peer has left: Python runs a
    handler only between the main thread's bytecodes, so a thread that
    the signal's wakeup fd wakes exits the process."""
    import threading
    r, w = os.pipe()
    os.set_blocking(w, False)
    signal.set_wakeup_fd(w)

    def watch():
        while True:
            if signal.SIGTERM in os.read(r, 64):
                os._exit(143)
    threading.Thread(target=watch, name='sigterm-exit', daemon=True).start()


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description='Train a Llama preset on one device or a mesh of ranks '
                    '(PyTorch port).')
    parser.add_argument('--model', default='tiny',
                        help='preset name (models/llama.py PRESETS)')
    parser.add_argument('--steps', type=int, default=100)
    parser.add_argument('--global-batch-size', type=int, default=2)
    parser.add_argument('--seq-len', type=int, default=128)
    parser.add_argument('--optimizer', default='adafactor')
    parser.add_argument('--accum-steps', type=int, default=1,
                        help='gradient accumulation: microbatches per '
                             'optimizer step (global batch must divide)')
    parser.add_argument('--total-steps', type=int, default=10_000,
                        help='LR cosine-decay horizon')
    parser.add_argument('--warmup-steps', type=int, default=100,
                        help='LR warmup steps (the LR is 0 at step 0)')
    parser.add_argument('--data', default=None,
                        help='pretokenized token file (train/data.py '
                             'TokenDataset); synthetic stream when unset')
    parser.add_argument('--ckpt-dir', default=None,
                        help='checkpoint dir (mounted bucket for recovery)')
    parser.add_argument('--ckpt-local-dir', default=None,
                        help='fast local staging dir: saves commit here '
                             'and mirror to --ckpt-dir in the background '
                             '(restore prefers local, falls back to the '
                             'bucket)')
    parser.add_argument('--ckpt-sync', action='store_true',
                        help='persist synchronously (stalls the step '
                             'loop for the full write; default is async '
                             '— the loop waits only to issue the '
                             'device->host copies)')
    parser.add_argument('--save-every', type=int, default=20)
    parser.add_argument('--log-every', type=int, default=10)
    parser.add_argument('--step-time-floor', type=float, default=0.0,
                        help='min seconds per step (tests use it to make '
                             'preemption windows deterministic)')
    parser.add_argument('--remat-policy', default='full',
                        help='remat policy (models/llama.py '
                             'REMAT_POLICIES)')
    parser.add_argument('--device', default=None,
                        help="'cpu' to run without a card; CUDA otherwise")
    parser.add_argument('--mesh', default=None,
                        help='logical mesh axes, e.g. "data=2,fsdp=-1,'
                             'tensor=4" (parallel/mesh.py MeshSpec; one '
                             'device when unset)')
    parser.add_argument('--num-slices', type=int, default=None,
                        help='slices in the mesh (data-parallel across '
                             'them); defaults to MEGASCALE_NUM_SLICES '
                             '(set by the gang driver on multislice '
                             'clusters), else 1')
    parser.add_argument('--lora-rank', type=int, default=0,
                        help='LoRA adapter rank; 0 = full finetune '
                             '(models/lora.py)')
    parser.add_argument('--lora-alpha', type=float, default=32.0)
    parser.add_argument('--lora-targets', default='wq,wk,wv,wo',
                        help='comma-separated weight names to adapt '
                             '(also: w_gate,w_up,w_down)')
    return parser


# The mesh axes the port does not train over yet (ROADMAP section 1, item 1).
_UNPORTED_AXES = {'pipe': 'pipeline stages',
                  'seq': 'sequence parallelism (ring attention)',
                  'expert': 'expert parallelism'}


def _plan_mesh(parser: argparse.ArgumentParser, args):
    """(axis sizes, num_slices, ranks) of the ``--mesh`` / ``--num-slices``
    request, or None without one (JAX's ``run.py:125-143``). Exits 2 for
    the axes not ported yet; a spec that does not divide raises JAX's
    ``ValueError``."""
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    num_slices = args.num_slices
    if num_slices is None:
        num_slices = int(os.environ.get('MEGASCALE_NUM_SLICES', '1'))
    if not args.mesh and num_slices <= 1:
        return None
    text = args.mesh or f'data={num_slices},fsdp=-1'
    try:
        spec = mesh_lib.parse_spec(text)
    except (TypeError, ValueError) as e:
        parser.exit(2, f'--mesh {text}: {e}\n')
    for axis, what in _UNPORTED_AXES.items():
        if getattr(spec, axis) != 1:
            parser.exit(2, f'--mesh {text}: {axis}={getattr(spec, axis)}: '
                           f'{what} is not ported yet (ROADMAP section 1, '
                           'item 1); the port trains over data, fsdp and '
                           'tensor\n')
    sizes = spec.__dict__
    if -1 in sizes.values():
        from skypilot_tpu_torch.utils.device import resolve_device
        ranks = mesh_lib.gang_devices(resolve_device(args.device).type)
    else:
        ranks = 1
        for n in sizes.values():
            ranks *= n
    return mesh_lib.resolve(spec, ranks, num_slices), num_slices, ranks


def _rank_summary(gang, trainer, state, losses, grad_norms, windows,
                  loop_stats) -> str:
    """The rank's figures as one JSON line (ranks share stdout); the
    collectives are the step loop's (its saves included)."""
    from skypilot_tpu_torch.ops import attention
    from skypilot_tpu_torch.train import optim
    fa = attention.flash_attention
    dev = trainer.device
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == 'cuda'
            else None)
    return json.dumps({
        'rank': gang.rank, 'world': gang.world, 'host': gang.host,
        'backend': gang.backend, 'device': str(dev),
        'losses': losses, 'grad_norms': grad_norms,
        'window_step_ms': windows,
        'launches': {'flash_fwd': fa.fwd_launches,
                     'flash_bwd_dq': fa.bwd_dq_launches,
                     'flash_bwd_dkv': fa.bwd_dkv_launches},
        'weight_bytes': sum(t.numel() * t.element_size() for t in
                            optim.tree_leaves(state['params'])),
        'peak_bytes': peak, 'collectives': loop_stats})


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    parser = build_parser()
    args = parser.parse_args(argv)
    plan = _plan_mesh(parser, args)
    gang = mesh = None
    if plan is not None and plan[2] > 1:
        from skypilot_tpu_torch.parallel import gang as gang_lib
        from skypilot_tpu_torch.parallel import mesh as mesh_lib
        from skypilot_tpu_torch.utils.device import resolve_device
        sizes, num_slices, ranks = plan
        gang = gang_lib.initialize(
            ranks, resolve_device(args.device).type,
            sys.argv[1:] if argv is None else argv,
            gang_lib.module_command('skypilot_tpu_torch.train.run'),
            f'the mesh {sizes} ({ranks} ranks)')
        mesh = mesh_lib.build_mesh(mesh_lib.MeshSpec(**sizes), num_slices,
                                   device=gang.device)
    if plan is not None and (gang is None or gang.is_head):
        print(f'[train] mesh {plan[0]} over {plan[1]} slice(s)', flush=True)
    try:
        return _train(args, gang, mesh)
    except BaseException:
        if gang is not None:
            # The ranks this process spawned cannot go on without it.
            gang.forward_signal(signal.SIGTERM)
            gang.release_children(30.0)
        raise


def _train(args, gang, mesh) -> Dict[str, Any]:
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.observability import train_telemetry
    from skypilot_tpu_torch.ops import attention
    from skypilot_tpu_torch.train import data as data_lib
    from skypilot_tpu_torch.train import trainer as trainer_lib

    lora_cfg = None
    if args.lora_rank > 0:
        from skypilot_tpu_torch.models import lora as lora_lib
        lora_cfg = lora_lib.LoraConfig(
            rank=args.lora_rank, alpha=args.lora_alpha,
            targets=tuple(t.strip()
                          for t in args.lora_targets.split(',') if t.strip()))
    cfg = trainer_lib.TrainerConfig(
        model=llama.PRESETS[args.model],
        global_batch_size=args.global_batch_size, seq_len=args.seq_len,
        optimizer=args.optimizer, accum_steps=args.accum_steps,
        total_steps=args.total_steps, warmup_steps=args.warmup_steps,
        remat=True, remat_policy=args.remat_policy, lora=lora_cfg)
    trainer = trainer_lib.Trainer(cfg, device=args.device, mesh=mesh)
    dev = trainer.device
    on_card = dev.type == 'cuda'
    card = torch.cuda.get_device_name(dev) if on_card else 'cpu'
    head = gang is None or gang.is_head
    if on_card:
        t0 = time.perf_counter()
        attention.build_library()
        if head:
            print(f'[train] flash-attention kernels ready in '
                  f'{time.perf_counter() - t0:.1f} s', flush=True)
    state = trainer.init_state(seed=0)
    lora_note = ''
    if lora_cfg is not None:
        from skypilot_tpu_torch.models import lora as lora_lib
        values = lora_lib.param_count(state['lora'])
        lora_note = (f' lora rank {lora_cfg.rank} alpha {lora_cfg.alpha:g} '
                     f'{",".join(sorted(lora_cfg.targets))} '
                     f'({values} adapter values'
                     + (' on this rank' if mesh is not None else '') + ')')
    moe_note, m = '', cfg.model
    if m.num_experts > 0:
        moe_note = (f', {m.active_param_count / 1e9:.2f}B active '
                    f'({m.active_param_count / m.param_count:.1%}): '
                    f'{m.expert_top_k} of {m.num_experts} experts')
    ranks_note = (f' x {gang.world} ranks ({gang.backend})'
                  if gang is not None else '')
    if head:
        print(f'[train] {args.model} ({cfg.model.param_count / 1e9:.2f}B '
              f'params{moe_note}) seq {cfg.seq_len} batch '
              f'{cfg.global_batch_size} {cfg.optimizer} remat '
              f'{cfg.remat_policy}{lora_note} on {card}{ranks_note}',
              flush=True)

    # Created before the checkpoint manager so restore/save records ride
    # the same spool as the loss windows; None unless the spool dir env
    # var is set (the gang driver exports it per worker). Under a mesh a
    # host's first rank writes it, as JAX's one process per host does.
    telem = (train_telemetry.TelemetryWriter.from_env()
             if gang is None or gang.local_rank == 0 else None)
    mgr, start_step, prev_handler = None, 0, None
    if args.ckpt_dir:
        from skypilot_tpu_torch.train import checkpoint as ckpt_lib
        mgr = ckpt_lib.CheckpointManager(
            args.ckpt_dir, save_interval_steps=args.save_every,
            async_save=not args.ckpt_sync,
            local_dir=args.ckpt_local_dir, telemetry=telem,
            trainer=trainer, gang=gang)
        restored = mgr.restore_latest(state)
        if restored is not None:
            state = restored
            start_step = state['step']
            if head:
                print(f'[train] resumed from checkpoint step {start_step}',
                      flush=True)
    if gang is not None:
        # Every rank: a host's first rank hands SIGTERM on to the ranks
        # it spawned, and no rank may linger in a collective.
        prev_handler = signal.signal(signal.SIGTERM,
                                     make_gang_sigterm_handler(mgr, gang))
        if not gang.children and (mgr is None or not mgr.writer):
            exit_on_sigterm_from_a_thread()
    elif mgr is not None:
        # Preemption hook: the agent driver's cancel path SIGTERMs the
        # gang (then escalates after a grace window) — persist the
        # freshest host-side snapshot before dying.
        prev_handler = signal.signal(signal.SIGTERM,
                                     make_sigterm_handler(mgr))

    dataset = None
    if args.data:
        # batch(step) is pure in step: resume replays the exact data
        # trajectory the checkpoint was trained on.
        dataset = data_lib.TokenDataset(args.data, seq_len=cfg.seq_len,
                                        batch_size=cfg.global_batch_size)
    flops = trainer_lib.model_flops_per_step(cfg)
    tokens = trainer_lib.tokens_per_step(cfg)
    # A gang shares its card's peak unless every rank has a card.
    cards = mesh.size if mesh is not None and mesh.backend == 'nccl' else 1
    losses: List[torch.Tensor] = []
    grad_norms: List[torch.Tensor] = []
    moe_aux: List[torch.Tensor] = []
    windows: List[float] = []
    loop_stats = None
    if gang is not None:
        from skypilot_tpu_torch.parallel import collectives
        collectives.reset_stats()  # the summary counts the step loop's
    try:
        window_t0, window_steps = time.perf_counter(), 0
        for i in range(start_step, args.steps):
            if dataset is not None:
                batch = dataset.batch(i)
            else:
                batch = next(iter(data_lib.synthetic_batches(
                    cfg.global_batch_size, cfg.seq_len,
                    cfg.model.vocab_size, seed=i, num_batches=1)))
            t0 = time.perf_counter()
            state, metrics = trainer.step(state, batch)
            losses.append(metrics['loss'])
            grad_norms.append(metrics['grad_norm'])
            if 'moe_aux' in metrics:
                moe_aux.append(metrics['moe_aux'])
            step, window_steps = i + 1, window_steps + 1
            if step % args.log_every == 0 or step == args.steps:
                loss = float(metrics['loss'])  # waits for the step
                if on_card:
                    torch.cuda.synchronize(dev)
                now = time.perf_counter()
                step_s = (now - window_t0) / window_steps
                windows.append(step_s * 1e3)
                rate = (f'mfu={trainer_lib.mfu(cfg, step_s) / cards:.2%} of '
                        f'{cards} x '
                        f'{H100_BF16_DENSE_FLOPS / 1e12:.0f} TFLOP/s bf16 '
                        'dense peak'
                        if on_card else 'mfu=not measured')
                aux = (f'moe_aux={float(metrics["moe_aux"]):.4f} '
                       if 'moe_aux' in metrics else '')
                if head:
                    print(f'[train] step {step}/{args.steps} '
                          f'loss={loss:.4f} {aux}step_ms={step_s * 1e3:.1f} '
                          f'tokens/s={tokens / step_s:.0f} '
                          f'model_flops/s={flops / step_s:.3e} {rate} '
                          f'({card})', flush=True)
                if telem is not None:
                    telem.emit(train_telemetry.window_record(
                        step=step, steps=window_steps,
                        window_s=now - window_t0, tokens_per_step=tokens,
                        model_flops_per_step=flops, loss=loss,
                        ts=time.time()))
                window_t0, window_steps = now, 0
            if mgr is not None:
                mgr.save(step, state)
            dt = time.perf_counter() - t0
            if args.step_time_floor > dt:
                time.sleep(args.step_time_floor - dt)
        if gang is not None:
            loop_stats = copy.deepcopy(collectives.STATS)
        if mgr is not None and mgr.saved_step != args.steps:
            mgr.save(args.steps, state, force=True)
    finally:
        if mgr is not None:
            mgr.close()  # flushes any in-flight async persist
        if prev_handler is not None or mgr is not None:
            signal.signal(signal.SIGTERM, prev_handler
                          if prev_handler is not None else signal.SIG_DFL)
    losses = torch.stack(losses).tolist() if losses else []
    grad_norms = torch.stack(grad_norms).tolist() if grad_norms else []
    if gang is not None:
        summary = _rank_summary(gang, trainer, state, losses, grad_norms,
                                windows, loop_stats)
        print(f'[train] rank-summary {summary}', flush=True)
        from skypilot_tpu_torch.parallel import gang as gang_lib
        gang.close(gang_lib.TIMEOUT_S)
    if head:
        print('[train] done', flush=True)
    return {'losses': losses,
            'grad_norms': grad_norms,
            'moe_aux': torch.stack(moe_aux).tolist() if moe_aux else [],
            'start_step': start_step, 'window_step_ms': windows,
            'state': state}


if __name__ == '__main__':
    main()
