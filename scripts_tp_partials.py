"""The two choices for the row-parallel partials of the port's
tensor-parallel compute, against one process, on the CPU.

A product whose contracting dim is cut over the model axis (``wo``'s over
the heads, ``w2``'s over the mlp columns) leaves each rank a partial that
the model group sums. The port keeps each partial in fp32 and rounds the
sum to bf16 once, as the one-process product (fp32 accumulation, one
rounding) does; the other choice keeps bf16 partials and sums them in bf16,
rounding twice. This script measures both against the one-process function:

* per block (``tests/test_torch_tp_blocks.py``'s cases on worlds of 2 and 4
  gloo ranks): the gap of the output and of every gradient, over the
  largest magnitude;
* end to end (reduced internlm2-1.8b on (1, 2) and (1, 4), production4bit
  with SR, 2 steps from the reference's params; ``torch_mesh_worker``'s
  ``tp_step``): the relative gap of each loss to the port's one-process
  run, in bf16 compute with each choice and in fp32 compute.

Run from the repository's root (JAX on the CPU gives the params):

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts_tp_partials.py
"""

import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))


def main():
    import torch

    import test_torch_tp_blocks as blocks
    import torch_mesh_worker as worker
    import torch_tp_ref as R
    from repro.configs import reduced_config as j_reduced
    from repro_torch.configs import reduced_config
    from repro_torch.convert import load_params
    from repro_torch.core.optimizers import make_optimizer
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels import sr
    from repro_torch.models import Transformer
    from repro_torch.train.train_loop import build_train_step, make_train_state
    from torch_ref import ref_params

    arch = "internlm2-1.8b"
    cfg = reduced_config(arch)
    params = R.flat(ref_params(j_reduced(arch)))
    data = SyntheticLM(DataConfig(cfg.vocab_size, 32, 8))
    batches = [data.batch_at(t) for t in range(2)]
    with tempfile.TemporaryDirectory() as tmp:
        worlds = {n: worker.start(n, {"blocks": {"kind": "tp_blocks", "cases": blocks.CASES}},
                                  os.path.join(tmp, f"blocks{n}")) for n in (2, 4)}
        runs = {}
        for partial in ("fp32", "bf16"):
            task = {"kind": "tp_step", "arch": arch, "meshes": [(1, 2)], "lr": R.LR,
                    "sr_seed": R.SEED, "params": params, "batches": batches,
                    "partial": partial, "fp32": partial == "fp32"}
            runs[partial] = worker.start(2, {"tp": task}, os.path.join(tmp, f"e2e_{partial}"))
        wide = {"kind": "tp_step", "arch": arch, "meshes": [(1, 4)], "lr": R.LR,
                "sr_seed": R.SEED, "params": params, "batches": batches, "fp32": True}
        runs["fp32_1x4"] = worker.start(4, {"tp": wide}, os.path.join(tmp, "e2e_1x4"))
        wide_bf16 = dict(wide, partial="bf16", fp32=False)
        runs["bf16_1x4"] = worker.start(4, {"tp": wide_bf16}, os.path.join(tmp, "e2e_1x4_bf16"))
        block_res = {n: [r["blocks"] for r in worker.collect(s)] for n, s in worlds.items()}
        e2e = {k: worker.collect(s)[0]["tp"] for k, s in runs.items()}

    print("per block: the largest gap of output and gradients over the largest magnitude")
    for i, case in enumerate(blocks.CASES):
        if case["dtype"] != "bf16":
            continue
        for n in (2, 4):
            got = blocks.gaps([r[i] for r in block_res[n]], case)
            name = f"{case['block']}{'-' + case['act'] if 'act' in case else ''}"
            out = {k: v for k, v in got.items() if k in ("y", "rows", "loss")}
            grads = max(v for k, v in got.items() if k not in out)
            print(f"  {name:10s} bf16 compute, partials {case['partial']}, {n} ranks: output "
                  f"{out}, gradients up to {grads:.3e}")

    def one_process(dtype):
        with worker._compute_dtype(dtype):
            model = Transformer(cfg, device="cpu")
            load_params(model, {k: torch.from_numpy(v) for k, v in params.items()})
            opt = make_optimizer("production4bit", R.LR)
            return worker._run_losses(build_train_step(model, opt),
                                      make_train_state(model, opt, key=sr.PRNGKey(R.SEED)),
                                      batches)

    one = {"bf16": one_process(torch.bfloat16), "fp32": one_process(torch.float32)}
    rel = lambda a, b: [float(abs(x / y - 1)) for x, y in zip(a, b)]
    print(f"end to end, reduced {arch}, 2 steps; one process: bf16 {one['bf16']}, "
          f"fp32 {one['fp32']}")
    for name, mesh in (("fp32", (1, 2)), ("bf16", (1, 2)), ("fp32_1x4", (1, 4)),
                       ("bf16_1x4", (1, 4))):
        res = e2e[name][mesh]
        partial = "bf16" if name.startswith("bf16") else "fp32"
        print(f"  {mesh} bf16 compute, partials {partial}: losses {res['losses']}, relative "
              f"gap {rel(res['losses'], one['bf16'])}")
        if "fp32" in res:
            fp32 = [x for x, _ in res["fp32"]]
            print(f"  {mesh} fp32 compute: losses {fp32}, relative gap {rel(fp32, one['fp32'])}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
