#!/usr/bin/env python3
"""Which op makes two identical bf16 r50dcn train steps differ, on one CUDA card.

    python3 -m petr_tpu_torch.repro_bisect

Run from the repository root: it takes ``chip_smoke.py``'s r50dcn set-up
(``petr_r50_p4_1408x512`` at full width, random weights from its seed with
the offset convs redrawn and the BN statistics normalised, one synthetic
batch). For each variant it runs two bf16 train steps from the same
weights, batch and generator seed, each on a fresh optimizer, and prints
whether the loss, ``grad_norm`` and every parameter after the update agree
bit for bit:

1. the bilinear corner gather's backward as ``torch.gather``'s (on CUDA a
   ``scatter_add`` with atomics): the port before its fix;
2. the same under ``torch.use_deterministic_algorithms(True)``, which makes
   that ``scatter_add`` deterministic and raises on an op that has no
   deterministic form (cuBLAS's workspace is pinned for it,
   ``CUBLAS_WORKSPACE_CONFIG=:4096:8``, for every variant);
3. the same with cuDNN's deterministic algorithms only
   (``torch.backends.cudnn.deterministic``);
4. the port's fixed-order gather backward (``ops/sampling.py::gather_rows``);
5. the fix with cuDNN's deterministic algorithms, which
   ``create_train_state`` pins: the port's train step.

Then the step's device time (the profiler's sum of kernel times) on three
routes, alternated three times: ``torch.gather``'s backward with cuDNN's
default algorithms (the port before the fix), the fixed gather with the
defaults, and the fixed gather with cuDNN's deterministic algorithms (the
port's step). Every time is printed with the card's name and power limit.
Exits 1 without a card.
"""

from __future__ import annotations

import os
import statistics
import sys


def main() -> int:
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")  # before CUDA starts
    import torch

    if not torch.cuda.is_available():
        print("repro_bisect: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from petr_tpu_torch.configs import get_config
    from petr_tpu_torch.ops import sampling
    from petr_tpu_torch.train import create_train_state, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.nvidia_smi("name,power.limit")
    print(card, flush=True)
    cfg = get_config(cs.R50)
    state = create_train_state(cfg, cs.SEED, total_steps=1000, device="cuda")
    cs.r50_random_weights(torch, cfg, state.model)
    initial = {k: v.clone() for k, v in state.model.state_dict().items()}
    del state
    batch = {k: torch.as_tensor(v).cuda() for k, v in cs.make_train_batch(cfg, cs.SEED).items()}
    step_fn = make_train_step(cfg)
    fixed = sampling.gather_rows

    def atomic(flat, idx):
        return torch.gather(flat, 1, idx[..., None].expand(*idx.shape, flat.shape[2]))

    def fresh_state():
        st = create_train_state(cfg, cs.SEED, total_steps=1000, device="cuda")
        st.model.load_state_dict(initial)
        return st

    def two_steps(label, gather, deterministic=False, cudnn_deterministic=False):
        sampling.gather_rows = gather
        torch.use_deterministic_algorithms(deterministic)
        runs = []
        try:
            for _ in range(2):
                st = fresh_state()  # pins cuDNN's deterministic algorithms: set the variant's after it
                torch.backends.cudnn.deterministic = cudnn_deterministic
                _, metrics = step_fn(st, batch, torch.Generator().manual_seed(cs.SEED + 11))
                runs.append((metrics["loss"].clone(), metrics["grad_norm"].clone(),
                             {n: p.detach().clone() for n, p in st.model.named_parameters()}))
                del st
        except RuntimeError as e:  # an op without a deterministic form under (2)
            print(f"{label}: raised {str(e).splitlines()[0]}", flush=True)
            return None
        finally:
            sampling.gather_rows = fixed
            torch.backends.cudnn.deterministic = False
            torch.use_deterministic_algorithms(False)
            torch.cuda.empty_cache()
        (l0, g0, p0), (l1, g1, p1) = runs
        differ = [n for n in p0 if not torch.equal(p0[n], p1[n])]
        same = torch.equal(l0, l1) and torch.equal(g0, g1) and not differ
        print(f"{label}: loss {l0.item():.9g} / {l1.item():.9g}, grad_norm {g0.item():.9g} / {g1.item():.9g}; "
              f"{len(differ)} of {len(p0)} parameters differ after the update"
              + (f" (first {differ[:4]})" if differ else "") + f": {'REPRODUCIBLE' if same else 'NOT reproducible'}",
              flush=True)
        return same

    two_steps("1. torch.gather backward (scatter_add with atomics)", atomic)
    two_steps("2. torch.gather backward, torch.use_deterministic_algorithms(True)", atomic, deterministic=True)
    two_steps("3. torch.gather backward, cudnn.deterministic", atomic, cudnn_deterministic=True)
    two_steps("4. the fix (gather_rows: index_put_ with accumulate, sorted)", fixed)
    two_steps("5. the fix, cudnn.deterministic (the port's step)", fixed, cudnn_deterministic=True)

    st = fresh_state()
    gen = torch.Generator().manual_seed(cs.SEED)

    def one_step():
        step_fn(st, batch, gen)

    for _ in range(2):
        one_step()
    torch.cuda.synchronize()
    routes = {"before: torch.gather backward, cuDNN default": (atomic, False),
              "the fixed gather, cuDNN default": (fixed, False),
              "after: the fixed gather, cuDNN deterministic": (fixed, True)}
    times = {label: [] for label in routes}
    backward_kernels = {label: [] for label in routes}
    for _ in range(3):
        for label, (gather, cudnn_deterministic) in routes.items():
            sampling.gather_rows = gather
            torch.backends.cudnn.deterministic = cudnn_deterministic
            try:
                one_step()  # a step on the route before it is profiled
                rows, _ = cs.profiled_kernels(torch, one_step, 2)
            finally:
                sampling.gather_rows = fixed
            times[label].append(sum(r[0] for r in rows))
            backward_kernels[label].append(sum(r[0] for r in rows if "scatter" in r[2] or "indexing_backward" in r[2]
                                               or "index_put" in r[2] or "radix" in r[2].lower()))
    for label, t in times.items():
        print(f"r50 bf16 step, {label}: device time per step {', '.join(f'{x:.3f}' for x in t)} ms (median "
              f"{statistics.median(t):.3f}); of it the gather's backward (scatter / index_put / sort kernels) "
              f"{', '.join(f'{x:.3f}' for x in backward_kernels[label])} ms [{card}]", flush=True)
    labels = list(routes)
    base = statistics.median(times[labels[0]])
    print(f"cost per r50 step against the route before (median of 3 alternated profiles of 2 steps each): the "
          f"fixed gather {statistics.median(times[labels[1]]) - base:.3f} ms, the fixed gather with cuDNN "
          f"deterministic {statistics.median(times[labels[2]]) - base:.3f} ms of device time [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
