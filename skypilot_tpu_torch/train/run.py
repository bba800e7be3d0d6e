"""Training entry point: ``python -m skypilot_tpu_torch.train.run``.

Port of ``skypilot_tpu/train/run.py`` for one device, e.g. BENCH_1B at
seq 4096 on one H100:

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

It takes the original's model, batch, optimizer, data, remat and
checkpoint flags (``--ckpt-dir``, ``--ckpt-local-dir``, ``--ckpt-sync``,
``--save-every``, ``--step-time-floor``), plus ``--warmup-steps`` and
``--device`` (CUDA unless ``cpu``). Checkpoints are the JAX package's
format (``ckpt/``), so a run of either package resumes from the other's.
On SIGTERM it persists the freshest snapshot and exits 143. LoRA
(``--lora-rank``, ``--lora-alpha``, ``--lora-targets``) trains adapters
over a frozen base. ``--mesh`` is accepted where its spec resolves to one
device (``fsdp=-1`` does, as it does on a one-chip host of the JAX
package); a spec that needs more devices, or ``--num-slices`` > 1 (or
``MEGASCALE_NUM_SLICES``), exits with code 2: meshes are not ported
yet. Every ``--log-every`` steps it prints
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
script can drive it in-process.
"""
from __future__ import annotations

import argparse
import os
import signal
import time
from typing import Any, Dict, List, Optional

import torch

from skypilot_tpu_torch.utils.device import H100_BF16_DENSE_FLOPS


def make_sigterm_handler(mgr):
    """The preemption SIGTERM handler: emergency-persist FIRST (the
    checkpoint write races the SIGKILL escalation deadline), then exit
    143, after one line on stderr with the durable step and the seconds
    the persist took. The JAX handler dumps a flight-recorder bundle
    between the two; the port has no flight recorder yet."""

    def _on_sigterm(signum, frame):
        del signum, frame
        t0 = time.perf_counter()
        step = mgr.emergency_persist()
        # os.write, not print: the signal may land inside a print of the
        # step loop, and a buffered stream refuses a reentrant write.
        os.write(2, f'[train] SIGTERM: emergency persist returned step '
                    f'{step} in {time.perf_counter() - t0:.3f} s\n'.encode())
        raise SystemExit(143)

    return _on_sigterm


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description='Train a Llama preset on one device (PyTorch port).')
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
                        help='logical mesh axes, e.g. "fsdp=-1" '
                             '(parallel/mesh.py MeshSpec); only specs '
                             'that resolve to one device are ported')
    parser.add_argument('--num-slices', type=int, default=None,
                        help='slices in the mesh; defaults to '
                             'MEGASCALE_NUM_SLICES, else 1; only 1 is '
                             'ported')
    parser.add_argument('--lora-rank', type=int, default=0,
                        help='LoRA adapter rank; 0 = full finetune '
                             '(models/lora.py)')
    parser.add_argument('--lora-alpha', type=float, default=32.0)
    parser.add_argument('--lora-targets', default='wq,wk,wv,wo',
                        help='comma-separated weight names to adapt '
                             '(also: w_gate,w_up,w_down)')
    return parser


def _check_mesh(parser: argparse.ArgumentParser, args) -> None:
    """Accept a mesh that resolves to the one device the port trains on
    (the JAX package builds the same one-device mesh on a one-chip host);
    exit 2 for anything larger."""
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    num_slices = args.num_slices
    if num_slices is None:
        num_slices = int(os.environ.get('MEGASCALE_NUM_SLICES', '1'))
    why = None
    if num_slices > 1:
        why = f'--num-slices {num_slices}'
    elif args.mesh:
        try:
            axes = {}
            for part in args.mesh.split(','):
                k, v = part.split('=')
                axes[k.strip()] = int(v)
            sizes = mesh_lib.MeshSpec(**axes).resolve(1)
        except (TypeError, ValueError) as e:
            why = f'--mesh {args.mesh} ({e})'
        else:
            if any(n != 1 for n in sizes.values()):
                why = f'--mesh {args.mesh}'
    if why is not None:
        parser.exit(2, f'{why}: a mesh over more than one device is not '
                       'ported yet (ROADMAP item 9; skypilot_tpu_torch '
                       'trains on one device)\n')


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    parser = build_parser()
    args = parser.parse_args(argv)
    _check_mesh(parser, args)

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
    trainer = trainer_lib.Trainer(cfg, device=args.device)
    dev = trainer.device
    on_card = dev.type == 'cuda'
    card = torch.cuda.get_device_name(dev) if on_card else 'cpu'
    if on_card:
        t0 = time.perf_counter()
        attention.build_library()
        print(f'[train] flash-attention kernels ready in '
              f'{time.perf_counter() - t0:.1f} s', flush=True)
    state = trainer.init_state(seed=0)
    lora_note = ''
    if lora_cfg is not None:
        from skypilot_tpu_torch.models import lora as lora_lib
        lora_note = (f' lora rank {lora_cfg.rank} alpha {lora_cfg.alpha:g} '
                     f'{",".join(sorted(lora_cfg.targets))} '
                     f'({lora_lib.param_count(state["lora"])} adapter '
                     'values)')
    moe_note, m = '', cfg.model
    if m.num_experts > 0:
        moe_note = (f', {m.active_param_count / 1e9:.2f}B active '
                    f'({m.active_param_count / m.param_count:.1%}): '
                    f'{m.expert_top_k} of {m.num_experts} experts')
    print(f'[train] {args.model} ({cfg.model.param_count / 1e9:.2f}B '
          f'params{moe_note}) seq {cfg.seq_len} batch {cfg.global_batch_size} '
          f'{cfg.optimizer} remat {cfg.remat_policy}{lora_note} on {card}',
          flush=True)

    # Created before the checkpoint manager so restore/save records ride
    # the same spool as the loss windows; None unless the spool dir env
    # var is set (the gang driver exports it per worker).
    telem = train_telemetry.TelemetryWriter.from_env()
    mgr, start_step, prev_handler = None, 0, None
    if args.ckpt_dir:
        from skypilot_tpu_torch.train import checkpoint as ckpt_lib
        mgr = ckpt_lib.CheckpointManager(
            args.ckpt_dir, save_interval_steps=args.save_every,
            async_save=not args.ckpt_sync,
            local_dir=args.ckpt_local_dir, telemetry=telem)
        restored = mgr.restore_latest(state)
        if restored is not None:
            state = restored
            start_step = state['step']
            print(f'[train] resumed from checkpoint step {start_step}',
                  flush=True)
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
    losses: List[torch.Tensor] = []
    moe_aux: List[torch.Tensor] = []
    windows: List[float] = []
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
                rate = (f'mfu={trainer_lib.mfu(cfg, step_s):.2%} of '
                        f'{H100_BF16_DENSE_FLOPS / 1e12:.0f} TFLOP/s bf16 '
                        'dense peak'
                        if on_card else 'mfu=not measured')
                aux = (f'moe_aux={float(metrics["moe_aux"]):.4f} '
                       if 'moe_aux' in metrics else '')
                print(f'[train] step {step}/{args.steps} loss={loss:.4f} '
                      f'{aux}step_ms={step_s * 1e3:.1f} '
                      f'tokens/s={tokens / step_s:.0f} '
                      f'model_flops/s={flops / step_s:.3e} {rate} ({card})',
                      flush=True)
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
        if mgr is not None and mgr.latest_step() != args.steps:
            mgr.save(args.steps, state, force=True)
    finally:
        if mgr is not None:
            mgr.close()  # flushes any in-flight async persist
            signal.signal(signal.SIGTERM, prev_handler
                          if prev_handler is not None else signal.SIG_DFL)
    print('[train] done', flush=True)
    return {'losses': torch.stack(losses).tolist() if losses else [],
            'moe_aux': torch.stack(moe_aux).tolist() if moe_aux else [],
            'start_step': start_step, 'window_step_ms': windows,
            'state': state}


if __name__ == '__main__':
    main()
