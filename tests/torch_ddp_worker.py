"""Train steps of the port on N ranks and on one (JAX-free, for
``tests/test_torch_ddp_step.py`` and ``tests/test_torch_gpu_ddp.py``).

A train-step case is a dict: ``model`` (``build_segmentor`` config),
``state`` (the net's state dict), ``batches`` (global numpy batches, one per
step), ``optimizer``, ``dtype`` (of the parameters), ``compute_dtype`` (the
segmentor's, float32 by default) and ``local_loss`` (True: every rank's loss
on its own rows with the local BatchNorm statistics, the gradients
averaged: what plain DDP computes). :func:`run_case` runs it on this
process's rank of the active group, or on one process without a group, and
returns the logs of each step, the net's state dict and the step's
collectives. A case of ``kind='bn'`` runs one train-mode ``BatchNorm2d``
instead (:func:`run_bn_case`).

As a script, one rank of a group joined through a ``file://`` store::

    python tests/torch_ddp_worker.py CASES.pt INIT_FILE RANK WORLD DEVICE OUT.pt

``CASES.pt`` holds the list of cases and the list of cases that rank 0
runs alone once the group has ended; ``OUT.pt`` receives the results of
both, in that order. Spawned as a new interpreter: the test process has
JAX loaded.

Under ``torch.distributed.run``, one rank of the launch as the CLIs start it
(``parallel.launcher_group``): it sums ``rank + 1`` over the ranks on
``DEVICE`` and prints its backend and the sum::

    python -m torch.distributed.run --nproc_per_node 2 tests/torch_ddp_worker.py --launcher DEVICE
"""
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def rows(batch, rank: int, world: int):
    """This rank's rows of a global numpy batch (rank order)."""
    def cut(v):
        n = v.shape[0] // world
        return v[rank * n:(rank + 1) * n]
    return {g: {k: cut(v) for k, v in batch[g].items()} for g in ('data', 'label')}


def batch_to(batch, device, dtype):
    """Tensors on ``device``, float arrays in ``dtype``."""
    return {g: {k: torch.from_numpy(np.ascontiguousarray(v)).to(device, dtype if v.dtype.kind == 'f' else None)
                for k, v in batch[g].items()} for g in ('data', 'label')}


def run_bn_case(case, device='cpu'):
    """``models/nn.py:BatchNorm2d`` in train mode on this rank's rows of the
    global input ``x`` (N, C, H, W) with ``weight`` and ``bias``, the loss
    ``sum(y * proj)`` over the rows: this rank's output and input gradient
    rows, the weight and bias gradients summed over ranks, the running
    statistics."""
    from tiseg_tpu_torch.models.nn import BatchNorm2d
    from tiseg_tpu_torch.parallel import reduce_gradients
    from tiseg_tpu_torch.utils.device import world_rank

    world, rank = world_rank()
    dtype = case['dtype']
    bn = BatchNorm2d(case['x'].shape[1]).to(device, dtype).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(case['weight']))
        bn.bias.copy_(torch.from_numpy(case['bias']))
    part = rows({'data': {'x': case['x'], 'proj': case['proj']}, 'label': {}}, rank, world)['data']
    x = torch.from_numpy(part['x']).to(device, dtype).requires_grad_()
    y = bn(x)
    (y * torch.from_numpy(part['proj']).to(device, dtype)).sum().backward()
    if world > 1:
        reduce_gradients([bn.weight, bn.bias])
    return {k: v.detach().cpu() for k, v in dict(y=y, x_grad=x.grad, weight_grad=bn.weight.grad,
                                                  bias_grad=bn.bias.grad, running_mean=bn.running_mean,
                                                  running_var=bn.running_var).items()}


def run_case(case, device='cpu'):
    if case.get('kind') == 'bn':
        return run_bn_case(case, device)
    from tiseg_tpu_torch import parallel
    from tiseg_tpu_torch.engine import build_lr_schedule, build_optimizer
    from tiseg_tpu_torch.engine.train_state import TrainState, make_train_step, trainable_parameters
    from tiseg_tpu_torch.models import build_segmentor
    from tiseg_tpu_torch.models.segmentors import base
    from tiseg_tpu_torch.models import nn as port_nn
    from tiseg_tpu_torch.utils.device import world_rank

    world, rank = world_rank()
    dtype = case['dtype']
    seg = build_segmentor(case['model'], device=device, dtype=case.get('compute_dtype', torch.float32))
    seg.net.to(dtype)
    seg.net.load_state_dict(case['state'])
    steps = len(case['batches'])
    opt = dict(case['optimizer'])
    tx = build_optimizer(opt, build_lr_schedule(dict(policy='fixed'), opt['lr'], 1, steps),
                         trainable_parameters(seg.net))
    state = TrainState.create(seg.net, tx, seed=case.get('seed', 0))
    group = torch.distributed.group.WORLD if world > 1 else None
    saved = []
    if case.get('local_loss') and world > 1:  # plain DDP: local statistics and loss, gradients averaged
        saved = [(mod, 'data_parallel', mod.data_parallel) for mod in (base, port_nn, parallel.data)]
        for mod, name, _ in saved:
            setattr(mod, name, lambda: False)
        loss = seg.loss
        seg.loss = lambda batch, generator=None: tuple(
            (t / world if i == 0 else t) for i, t in enumerate(loss(batch, generator=generator)))
    try:
        step = make_train_step(seg, group=group)
        logs, counts = [], []
        for b in case['batches']:
            parallel.data.COUNTS.update(collectives=0, bytes=0)
            state, out = step(state, batch_to(rows(b, rank, world), device, dtype))
            logs.append({k: float(v) for k, v in out.items()})
            counts.append(dict(parallel.data.COUNTS))
    finally:
        for mod, name, value in saved:
            setattr(mod, name, value)
    return {'logs': logs, 'state': {k: v.detach().cpu() for k, v in seg.net.state_dict().items()},
            'collectives': counts}


def launcher(device):
    sys.path.insert(0, ROOT)
    from tiseg_tpu_torch.parallel import launcher_group
    with launcher_group(device) as (world, rank, dev):
        total = torch.tensor([rank + 1.0], device=dev)
        torch.distributed.all_reduce(total)
        print(f'launcher rank {rank} of {world}: {torch.distributed.get_backend()} on {dev}, sum {total.item()}',
              flush=True)


def main(argv):
    if argv[0] == '--launcher':
        return launcher(argv[1])
    cases_file, init_file, rank, world, device, out = argv
    os.environ.update(RANK=rank, WORLD_SIZE=world, LOCAL_RANK=rank)
    sys.path.insert(0, ROOT)
    torch.set_num_threads(1)
    from tiseg_tpu_torch.parallel import init_distributed
    init_distributed(backend='gloo', init_method=f'file://{init_file}', device=device)
    cases, alone = torch.load(cases_file, weights_only=False)
    try:
        results = [run_case(c, device) for c in cases]
    finally:
        torch.distributed.destroy_process_group()
    if rank == '0':
        results += [run_case(c, device) for c in alone]
    torch.save(results, out)


def spawn(cases, tmp, world: int = 2, device: str = 'cpu', timeout: float = 120, alone=()):
    """Start ``world`` ranks on ``cases`` (new interpreters, one thread
    each), rank 0 then running ``alone`` without a group; returns a function
    that waits for them and gives each rank's list of results, in rank
    order, rank 0's followed by those of ``alone`` (it raises with their
    stderr on a failure or after ``timeout`` seconds)."""
    import subprocess
    tmp = str(tmp)
    cases_file = os.path.join(tmp, 'cases.pt')
    torch.save((list(cases), list(alone)), cases_file)
    init = os.path.join(tmp, 'init')
    outs = [os.path.join(tmp, f'out{r}.pt') for r in range(world)]
    env = dict(os.environ, OMP_NUM_THREADS='1')
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), cases_file, init, str(r), str(world), device,
                               outs[r]], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(world)]

    def wait():
        errs = []
        try:
            for p in procs:
                errs.append(p.communicate(timeout=timeout)[1])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if any(p.returncode for p in procs):
            raise RuntimeError('\n'.join(e[-3000:] for e in errs))
        return [torch.load(o, weights_only=False) for o in outs]

    return wait


if __name__ == '__main__':
    main(sys.argv[1:])
