"""End-to-end driver: train a ~20M-parameter dense LM for a few hundred
steps with the full substrate — data pipeline, AdamW, remat,
checkpointing, manifest attestation, straggler tracking — through the
port's training launcher (attention through the flash kernel on a card).

    PYTHONPATH=src python examples/torch/train_lm.py --steps 200 [--device cpu]

Mirrors ``examples/train_lm.py``.  The small config is handed to the
launcher through its arch resolver for this run only: no registry changes,
and the resolver is restored afterwards.
"""
import argparse
import dataclasses
import json
import tempfile
from pathlib import Path

from repro_torch.configs import ALL_ARCHS
from repro_torch.kernels import ops
from repro_torch.launch import train as T


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--out", default=str(Path(tempfile.gettempdir())
                                         / "repro_torch_train_lm"))
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args()

    # ~20M-parameter member of the phi3 (dense) family
    base = ALL_ARCHS["phi3-mini-3.8b"]
    small = dataclasses.replace(
        base, name="phi3-20m", n_layers=6, d_model=384, n_heads=6,
        n_kv_heads=6, head_dim=64, d_ff=1024, vocab_size=8192)

    orig = T.resolve_arch
    T.resolve_arch = lambda name: small if name == "phi3-20m" else orig(name)
    try:
        res = T.train("phi3-20m", smoke=False, steps=args.steps,
                      seq_len=64, global_batch=4,
                      ckpt_every=max(args.steps // 4, 1), out_dir=args.out,
                      device=args.device)
    finally:
        T.resolve_arch = orig
    print(json.dumps(res, indent=1, default=str))
    assert res["loss_decreased"], "training did not reduce the loss"
    assert res["audit"]["gate_ok"], res["audit"]["findings"]
    manifest = json.loads((Path(args.out) / "manifest.json").read_text())
    assert manifest["image_hash"] == res["image_hash"]
    print(f"image {res['image_hash']} on "
          f"{manifest['binding']['device_kind']}, step program "
          f"{manifest['attestation']['program_fingerprint']}")
    print(f"LAUNCHES {json.dumps(ops.LAUNCHES)}")
    print("OK")


if __name__ == "__main__":
    main()
