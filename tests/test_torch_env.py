"""The port's one-GPU environment layer, held against the reference on the
CPU: the configs the registry reads, ``core.registry``, ``core.bootstrap``
(``WireUp`` and the wire-up branch), ``core.manifest``, ``core.attest``
(the step's program and its transport report), ``launch.slurm``,
``runtime.health`` and the wire-up of the train CLI.

Every environment variable a test sets goes through ``monkeypatch``; no
test calls the real ``init_process_group`` or binds a port; every file a
test writes lies under ``tmp_path``.  Comparisons are exact (configs,
scripts, triples, plans, tags, losses) unless a tolerance is stated.
"""
import ast
import contextlib
import dataclasses
import json
from pathlib import Path

import pytest
import torch

from _torch_threads import one_intra_op_thread  # noqa: F401
from repro_torch import configs as T_CONFIGS
from repro_torch.audit import AuditContext, RunAudit
from repro_torch.configs import reduced as t_reduced
from repro_torch.configs.base import RunConfig, ShapeConfig, TrainConfig
from repro_torch.core import attest
from repro_torch.core import bootstrap as T_BOOT
from repro_torch.core import manifest as T_MAN
from repro_torch.core import registry as T_REG
from repro_torch.core.diagnostics import Diagnostics
from repro_torch.launch import slurm as T_SLURM
from repro_torch.launch import train as T_TRAIN
from repro_torch.models import build as t_build
from repro_torch.runtime import health as T_HEALTH
from repro_torch.train.step import init_train_state, make_train_step

jax = pytest.importorskip("jax")
from repro import configs as R_CONFIGS  # noqa: E402
from repro.core import bootstrap as R_BOOT  # noqa: E402
from repro.core import manifest as R_MAN  # noqa: E402
from repro.core import registry as R_REG  # noqa: E402
from repro.launch import slurm as R_SLURM  # noqa: E402
from repro.runtime import health as R_HEALTH  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
ARCH = "deepseek-7b"
SLURM_VARS = ("SLURM_NTASKS", "SLURM_PROCID", "SLURM_STEP_NODELIST",
              "REPRO_COORD_PORT")


# ------------------------------------------------------- configs, registry


def test_shapes_and_meshes_equal_the_reference():
    assert list(T_CONFIGS.SHAPES) == list(R_CONFIGS.SHAPES)
    for name in R_CONFIGS.SHAPES:
        assert (dataclasses.asdict(T_CONFIGS.SHAPES[name])
                == dataclasses.asdict(R_CONFIGS.SHAPES[name])), name
    assert ([(f.name, f.default) for f in
             dataclasses.fields(T_CONFIGS.MeshConfig)]
            == [(f.name, f.default) for f in
                dataclasses.fields(R_CONFIGS.MeshConfig)])
    for name in ("TINY_MESH", "SINGLE_POD", "MULTI_POD"):
        t, r = getattr(T_CONFIGS, name), getattr(R_CONFIGS, name)
        assert dataclasses.asdict(t) == dataclasses.asdict(r), name
        assert (t.n_devices, t.batch_axes, t.model_axes) == (
            r.n_devices, r.batch_axes, r.model_axes), name
        for axis in ("pod", "data", "model", "none"):
            assert t.axis_size(axis) == r.axis_size(axis), (name, axis)


def test_applicable_shapes_and_cells_equal_the_reference():
    assert T_CONFIGS.SUBQUADRATIC == R_CONFIGS.SUBQUADRATIC
    for arch in R_CONFIGS.ALL_ARCHS:
        assert (T_CONFIGS.applicable_shapes(arch)
                == R_CONFIGS.applicable_shapes(arch)), arch
    cells = T_REG.all_cells()
    assert cells == R_REG.all_cells()
    assert len(cells) == 32


@pytest.mark.parametrize("name", ["deepseek-7b", "deepseek_7b",
                                  "llama-3.2-vision-11b",
                                  "llama_3_2_vision_11b", "mamba2_2_7b"])
def test_registry_resolves_as_the_reference(name):
    assert (dataclasses.asdict(T_REG.resolve_arch(name))
            == dataclasses.asdict(R_REG.resolve_arch(name)))
    assert (dataclasses.asdict(T_REG.smoke_config(name))
            == dataclasses.asdict(R_REG.smoke_config(name)))


def test_registry_refuses_unknown_names_as_the_reference():
    for t_fn, r_fn in ((T_REG.resolve_arch, R_REG.resolve_arch),
                       (T_REG.resolve_shape, R_REG.resolve_shape)):
        with pytest.raises(KeyError) as t_err:
            t_fn("no-such")
        with pytest.raises(KeyError) as r_err:
            r_fn("no-such")
        assert str(t_err.value) == str(r_err.value)
    for name in R_CONFIGS.SHAPES:
        assert (dataclasses.asdict(T_REG.resolve_shape(name))
                == dataclasses.asdict(R_REG.resolve_shape(name)))


# ------------------------------------------------------------- bootstrap


def _class_source(path: Path, name: str) -> str:
    src = path.read_text()
    node = next(n for n in ast.parse(src).body
                if isinstance(n, ast.ClassDef) and n.name == name)
    return ast.get_source_segment(src, node)


def test_wireup_is_the_reference_verbatim():
    port = REPO / "src/repro_torch/core/bootstrap.py"
    ref = REPO / "src/repro/core/bootstrap.py"
    assert _class_source(port, "WireUp") == _class_source(ref, "WireUp")


@pytest.mark.parametrize("env", [
    {},
    {"SLURM_NTASKS": "1"},
    {"SLURM_NTASKS": "128", "SLURM_PROCID": "7",
     "SLURM_STEP_NODELIST": "nid[001-032]"},
    {"SLURM_NTASKS": "4", "SLURM_PROCID": "3",
     "SLURM_STEP_NODELIST": "gpu-a,gpu-b", "REPRO_COORD_PORT": "29500"},
])
def test_wireup_from_env_gives_the_reference_triple(monkeypatch, env):
    for var in SLURM_VARS:
        monkeypatch.delenv(var, raising=False)
    for var, value in env.items():
        monkeypatch.setenv(var, value)
    t, r = T_BOOT.WireUp.from_env(), R_BOOT.WireUp.from_env()
    assert dataclasses.asdict(t) == dataclasses.asdict(r)
    assert t.is_distributed == r.is_distributed


def _record_init(monkeypatch) -> list:
    calls = []
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda **kw: calls.append(kw))
    return calls


@pytest.mark.parametrize("device,backend", [("cpu", "gloo"),
                                            ("cuda", "nccl")])
def test_init_distributed_binds_the_triple(monkeypatch, device, backend):
    calls = _record_init(monkeypatch)
    single = T_BOOT.WireUp("localhost:9876", 1, 0)
    assert T_BOOT.init_distributed(single, device) is single
    assert calls == []
    multi = T_BOOT.WireUp("nid001:29500", 4, 3)
    assert T_BOOT.init_distributed(multi, device) is multi
    assert calls == [{"backend": backend, "init_method": "tcp://nid001:29500",
                      "world_size": 4, "rank": 3}]


# -------------------------------------------------------------- manifest


@pytest.mark.parametrize("arch", sorted(R_CONFIGS.ALL_ARCHS))
def test_portable_env_dicts_equal_the_reference(arch):
    t = T_MAN.PortableEnv.capture(T_CONFIGS.ALL_ARCHS[arch],
                                  T_CONFIGS.SHAPES["train_4k"],
                                  T_CONFIGS.TrainConfig(), "baseline")
    r = R_MAN.PortableEnv.capture(R_CONFIGS.ALL_ARCHS[arch],
                                  R_CONFIGS.SHAPES["train_4k"],
                                  R_CONFIGS.TrainConfig(), "baseline")
    for part in ("model", "shape", "train", "rules", "numpy_version",
                 "python_version", "dtype_policy"):
        assert getattr(t, part) == getattr(r, part), part
    assert t.torch_version == torch.__version__
    assert t.cuda_version == torch.version.cuda
    assert "sm_90a" in t.nvcc_flags
    assert not hasattr(t, "jax_version") and not hasattr(t, "xla_flags")


def test_manifest_roundtrip_and_hash_stability():
    env = T_MAN.PortableEnv.capture(T_CONFIGS.ALL_ARCHS["phi3-mini-3.8b"],
                                    T_CONFIGS.SHAPES["train_4k"])
    m = T_MAN.Manifest(env).bind("cpu", T_CONFIGS.TINY_MESH)
    m.attest(program_text="aten::mm(...)", collectives={"counts": {}})
    m2 = T_MAN.Manifest.from_json(m.to_json())
    assert m2.portable.image_hash == env.image_hash
    assert m2.binding == m.binding and m2.attestation == m.attestation
    assert T_MAN.diff(m, m2) == []
    env2 = T_MAN.PortableEnv.capture(T_CONFIGS.ALL_ARCHS["phi3-mini-3.8b"],
                                     T_CONFIGS.SHAPES["train_4k"])
    assert env2.image_hash == env.image_hash
    # the reference's top-level keys
    r = R_MAN.Manifest(R_MAN.PortableEnv.capture(
        R_CONFIGS.ALL_ARCHS["phi3-mini-3.8b"], R_CONFIGS.SHAPES["train_4k"]))
    assert list(json.loads(m.to_json())) == list(json.loads(r.to_json()))


def _pair(pkg_configs, man, shapes, program_a, program_b, **kw):
    """Two manifests of deepseek-7b on ``shapes``, attested with two
    program texts (the reference's ``hlo_text``, the port's
    ``program_text``)."""
    key = "hlo_text" if man is R_MAN else "program_text"
    out = []
    for shape, text in zip(shapes, (program_a, program_b)):
        env = man.PortableEnv.capture(pkg_configs.ALL_ARCHS[ARCH],
                                      pkg_configs.SHAPES[shape])
        out.append(man.Manifest(env).attest(**{key: text}, **kw))
    return out


@pytest.mark.parametrize("shapes,texts", [
    (("train_4k", "train_4k"), ("program A", "program B")),   # UNEXPECTED
    (("train_4k", "decode_32k"), ("program A", "program B")),  # EXPECTED
    (("train_4k", "decode_32k"), ("program A", "program A")),  # portable
    (("train_4k", "train_4k"), ("program A", "program A")),    # equal
])
def test_diff_tags_equal_the_reference(shapes, texts):
    t_lines = T_MAN.diff(*_pair(T_CONFIGS, T_MAN, shapes, *texts))
    r_lines = R_MAN.diff(*_pair(R_CONFIGS, R_MAN, shapes, *texts))
    assert [line.replace("program_fingerprint", "hlo_fingerprint")
            for line in t_lines] == r_lines
    assert (shapes[0] != shapes[1]) == any(
        line.startswith("portable.shape") for line in t_lines)


def test_diff_tags_a_host_difference_as_expected():
    """Same image, another binding, another program: the CPU against the
    card, as ``chip_smoke.py`` checks it."""
    env = T_MAN.PortableEnv.capture(T_CONFIGS.ALL_ARCHS[ARCH],
                                    T_CONFIGS.SHAPES["train_4k"])
    cpu = T_MAN.Manifest(env).bind("cpu", T_CONFIGS.TINY_MESH)
    card = T_MAN.Manifest(env, binding=dataclasses.replace(
        cpu.binding, device_kind="NVIDIA H100 80GB HBM3", platform_="gpu"))
    cpu.attest(program_text="plain::flash_attention_plain(...)")
    card.attest(program_text="kernel::flash_attention(...)")
    lines = T_MAN.diff(card, cpu)
    assert lines[0].startswith("binding.device_kind:") and "(host)" in lines[0]
    assert lines[-1].endswith("[EXPECTED (binding differs)]")
    same = T_MAN.Manifest(env, binding=cpu.binding).attest(
        program_text="kernel::flash_attention(...)")
    assert T_MAN.diff(same, cpu)[-1].endswith(
        "[UNEXPECTED — same env+binding, different program]")


def test_cpu_binding_records_no_figures():
    b = T_MAN.HostBinding.capture("cpu", T_CONFIGS.TINY_MESH)
    assert (b.device_kind, b.n_devices, b.mesh_shape, b.mesh_axes,
            b.platform_) == ("cpu", 1, (1, 1), ("data", "model"), "cpu")
    assert (b.driver_version, b.power_limit, b.peak_flops, b.hbm_bw) == (
        None, None, None, None)


@pytest.mark.parametrize("name,peaks", [
    ("NVIDIA H100 80GB HBM3", (989e12, 3.35e12)),
    ("NVIDIA A100-SXM4-80GB", (None, None)),
], ids=["h100", "off-table"])
def test_card_binding_takes_nvidia_smi_and_the_peak_table(monkeypatch, name,
                                                          peaks):
    """The CUDA branch of ``HostBinding.capture``, with the card's calls
    stood in for: its name from ``torch.cuda``, power limit and driver from
    ``nvidia-smi``, peaks only for a card in the table."""
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i: name)
    monkeypatch.setattr(T_MAN, "nvidia_smi",
                        lambda i: (name, "700.00 W", "570.86.15"))
    b = T_MAN.HostBinding.capture("cuda", T_CONFIGS.TINY_MESH)
    assert (b.device_kind, b.platform_, b.power_limit, b.driver_version) == (
        name, "gpu", "700.00 W", "570.86.15")
    assert (b.peak_flops, b.hbm_bw) == peaks


def test_no_tpu_figure_in_the_port():
    """The reference's v5e defaults (``197e12``, ``819e9``, ``50e9``) appear
    nowhere in the port, its examples or its chip check."""
    paths = (sorted((REPO / "src/repro_torch").rglob("*.py"))
             + sorted((REPO / "examples/torch").glob("*.py"))
             + [REPO / "chip_smoke.py"])
    for path in paths:
        text = path.read_text()
        for figure in ("197e12", "819e9", "50e9"):
            assert figure not in text, (path, figure)


# ---------------------------------------------------------------- attest


def _step(remat="full", seq=32, batch=2):
    cfg = t_reduced(T_CONFIGS.ALL_ARCHS[ARCH])
    model = t_build(cfg)
    shape = ShapeConfig("t", "train", seq, batch)
    step = make_train_step(model, RunConfig(cfg, shape,
                                            TrainConfig(remat=remat)))

    def fresh(seed=0):
        return (init_train_state(model, torch.Generator().manual_seed(seed),
                                 "cpu"),
                model.sample_batch(shape, seed, "cpu"))
    return step, fresh


def _recorded(step, state, batch):
    with attest.record() as program:
        state, metrics = step(state, batch)
    return program, state, metrics


def test_program_fingerprint_is_stable_and_tracks_the_step():
    step, fresh = _step()
    fingerprints = []
    for seed in (0, 0, 1):       # the program records shapes, not values
        program, _, _ = _recorded(step, *fresh(seed))
        fingerprints.append(T_MAN.Manifest(None).attest(
            program_text=program.text).attestation["program_fingerprint"])
    assert len(set(fingerprints)) == 1
    for other in (_step(remat="none"), _step(seq=64)):
        program, _, _ = _recorded(other[0], *other[1]())
        assert T_MAN.Manifest(None).attest(
            program_text=program.text).attestation[
                "program_fingerprint"] != fingerprints[0]


def test_cpu_program_names_the_plain_versions():
    step, fresh = _step()
    program, _, _ = _recorded(step, *fresh())
    calls = [line for line in program.lines
             if line.startswith(("kernel::", "plain::"))]
    # 4 layers, each forward and its remat recompute in the backward
    assert calls == ["plain::flash_attention_plain("
                     + ", ".join(["bfloat16[8,32,32]@cpu"] * 3) + ")"] * 8
    assert any(line.startswith("aten::mm") for line in program.lines)
    report = attest.parse_program(program.text)
    assert report.ops == [] and report.findings == []
    # outside a recording the entry points write nothing
    attest.note("kernel", "flash_attention", torch.zeros(1))


def test_recording_leaves_the_step_bit_for_bit():
    step, fresh = _step()
    runs = []
    for record in (True, False):
        state, batch = fresh()
        losses = []
        for i in range(3):
            if record and i == 0:
                _, state, metrics = _recorded(step, state, batch)
            else:
                state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
        runs.append((losses, [t.clone() for t in
                              torch.utils._pytree.tree_leaves(state.params)]))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


def test_item_inside_a_step_fails_train_transport():
    step, fresh = _step()

    def leaky(state, batch):
        state, metrics = step(state, batch)
        metrics["loss"].item()          # a host sync inside the step
        return state, metrics

    program, _, _ = _recorded(leaky, *fresh())
    report = attest.parse_program(program.text)
    assert [f["kind"] for f in report.findings] == ["host-transfer"]
    audit = RunAudit(AuditContext(workload="train", family="dense",
                                  arch=ARCH, mesh=(1, 1)))
    found = audit.evaluate(transport=report)
    assert [f["kind"] for f in found] == ["pathway-host-transfer"]
    assert "[train-transport]" in found[0]["detail"]
    diag = audit.finish(Diagnostics(), transport=report)
    assert not diag.gate()


def test_parse_program_reads_copies_and_collectives():
    text = "\n".join([
        "aten::_to_copy(float32[4,8]@cuda) -> float32[4,8]@cpu",
        "aten::copy_(float32[4]@cpu, float32[4]@cuda) -> float32[4]@cpu",
        "aten::_to_copy(float32[4,8]@cpu) -> float32[4,8]@cuda",
        "aten::mm(bfloat16[4,8]@cuda, bfloat16[8,8]@cuda) -> "
        "bfloat16[4,8]@cuda",
        "c10d::allreduce_(float32[1024]@cuda) -> float32[1024]@cuda",
        "_c10d_functional::all_gather_into_tensor(bfloat16[64,8]@cuda) -> "
        "bfloat16[256,8]@cuda",
        "kernel::flash_attention(bfloat16[8,64,32]@cuda)",
    ])
    report = attest.parse_program(text, n_devices=4)
    assert [f["detail"].split(":")[0] for f in report.findings] == [
        "op 0", "op 1"]
    assert [(op.kind, op.payload_bytes, op.group_size) for op in report.ops
            ] == [("all-reduce", 4096, 4), ("all-gather", 4096, 4)]
    assert report.counts() == {"all-reduce": 1, "all-gather": 1}


# ------------------------------------------------------------------ slurm


def _as_port(text: str, gpus: int = 4) -> str:
    """The reference's script with the port's four substitutions."""
    subs = [
        ("python -m repro.launch.", "python -m repro_torch.launch."),
        ("export JAX_PLATFORMS=tpu",
         "export CUDA_VISIBLE_DEVICES="
         + ",".join(str(i) for i in range(gpus))),
        ("# One process per host; each host drives its local TPU devices.",
         "# One process per host; each host drives its local GPUs."),
        ("# by repro.core.bootstrap.WireUp", "# by repro_torch.core.bootstrap"
         ".WireUp"),
        ("#SBATCH --output=%x-%j.out\n\n",
         f"#SBATCH --output=%x-%j.out\n#SBATCH --gres=gpu:{gpus}\n"),
    ]
    for old, new in subs:
        assert text.count(old) == 1, old
        text = text.replace(old, new)
    return text


def test_emit_all_equals_the_reference_but_for_the_substitutions(tmp_path):
    t_paths = T_SLURM.emit_all(out_dir=tmp_path / "port")
    r_paths = R_SLURM.emit_all(out_dir=tmp_path / "ref")
    assert len(t_paths) == len(r_paths) == 32
    assert [p.name for p in t_paths] == [p.name for p in r_paths]
    for t, r in zip(t_paths, r_paths):
        assert t.read_text() == _as_port(r.read_text()), t.name


def test_emit_sbatch_keeps_the_container_and_the_wireup(tmp_path):
    kw = dict(nodes=2, entry="train", container_image="repro.sif")
    t = T_SLURM.emit_sbatch("deepseek-7b", "train_4k", gpus=8,
                            out_dir=tmp_path / "port", **kw).read_text()
    r = R_SLURM.emit_sbatch("deepseek-7b", "train_4k",
                            out_dir=tmp_path / "ref", **kw).read_text()
    assert t == _as_port(r, gpus=8)
    assert "apptainer exec --nv repro.sif python -m repro_torch" in t
    assert "export REPRO_COORD_PORT=9876" in t


# ----------------------------------------------------------------- health


def _plans(health, scenario):
    class Clock:
        t = 0.0

        def __call__(self):
            return self.t

    clock = Clock()
    out = []
    if scenario == "dead":
        reg = health.HealthRegistry(n_hosts=4, suspect_s=10, dead_s=60,
                                    clock=clock)
        out.append(reg.healthy)
        for t in range(0, 70, 5):
            clock.t = float(t)
            for h in (0, 1, 3):
                reg.beat(h)
        out.append({h: s.value for h, s in reg.sweep().items()})
        out.append(reg.survivors)
        out.append(health.plan_restart(reg, last_checkpoint=100, min_hosts=3,
                                       grace_s=30, silence_s=70))
    elif scenario == "transient":
        reg = health.HealthRegistry(n_hosts=2, suspect_s=10, dead_s=60,
                                    clock=clock)
        clock.t = 15.0
        reg.beat(0)
        out.append(health.plan_restart(reg, None, min_hosts=2, grace_s=30,
                                       silence_s=15))
        reg.beat(1)
        out.append(reg.healthy)
        out.append(health.plan_restart(reg, 7, min_hosts=2, grace_s=30,
                                       silence_s=0))
    else:
        reg = health.HealthRegistry(n_hosts=2, suspect_s=1, dead_s=5,
                                    clock=clock)
        clock.t = 10.0
        reg.beat(0)
        out.append(health.plan_restart(reg, 42, min_hosts=2, grace_s=1,
                                       silence_s=10))
    return [dataclasses.asdict(x) if dataclasses.is_dataclass(x) else x
            for x in out]


@pytest.mark.parametrize("scenario", ["dead", "transient", "too_few"])
def test_restart_plans_equal_the_reference(scenario):
    t, r = _plans(T_HEALTH, scenario), _plans(R_HEALTH, scenario)
    assert t == r
    assert any(isinstance(x, dict) and "action" in x for x in t)


# ------------------------------------------------------------- train CLI


@contextlib.contextmanager
def _unrecorded():
    yield attest.Program()


def test_train_cli_result_and_manifest_match_the_reference(tmp_path,
                                                           monkeypatch):
    from repro.launch.train import train as r_train
    for var in SLURM_VARS:
        monkeypatch.delenv(var, raising=False)
    kw = dict(steps=3, seq_len=32, global_batch=2, ckpt_every=3)
    ref = r_train(ARCH, out_dir=str(tmp_path / "ref"), **kw)
    port = T_TRAIN.train(ARCH, out_dir=str(tmp_path / "port"), device="cpu",
                         **kw)
    assert set(port) >= set(ref)
    for key, value in ref.items():
        if value is not None:
            assert port[key] is not None, key
            assert type(port[key]) is type(value), key
    assert set(port["audit"]) == set(ref["audit"])
    assert port["audit"]["gate_ok"] is True and port["audit"]["findings"] == []
    assert port["diagnostics"] == ref["diagnostics"] == "ok"
    assert port["wireup"] == ref["wireup"]

    t_man = json.loads((tmp_path / "port" / "manifest.json").read_text())
    r_man = json.loads((tmp_path / "ref" / "manifest.json").read_text())
    assert list(t_man) == list(r_man)
    assert t_man["image_hash"] == port["image_hash"]
    assert sorted(t_man["attestation"]) == sorted(
        k.replace("hlo_", "program_") for k in r_man["attestation"])
    assert t_man["attestation"]["collectives"]["counts"] == {}
    assert t_man["binding"]["mesh_shape"] == [1, 1]
    ckpt = json.loads((tmp_path / "port" / "ckpt" / "step_00000003"
                       / "manifest.json").read_text())
    assert ckpt["extra"]["image_hash"] == port["image_hash"]

    # the same run without attestation gives the same losses, bit for bit
    monkeypatch.setattr(T_TRAIN.attest, "record", _unrecorded)
    bare = T_TRAIN.train(ARCH, out_dir=str(tmp_path / "bare"), device="cpu",
                         **kw)
    assert bare["losses"] == port["losses"]


def test_train_cli_wires_up_from_slurm(tmp_path, monkeypatch):
    """Under a two-task Slurm step the launcher binds the process group
    (recorded, not made) and takes its half of each batch."""
    calls = _record_init(monkeypatch)
    for var, value in (("SLURM_NTASKS", "2"), ("SLURM_PROCID", "1"),
                       ("SLURM_STEP_NODELIST", "nid[007-008]"),
                       ("REPRO_COORD_PORT", "29511")):
        monkeypatch.setenv(var, value)
    res = T_TRAIN.train(ARCH, steps=1, seq_len=32, global_batch=4,
                        out_dir=str(tmp_path), device="cpu")
    assert calls == [{"backend": "gloo", "init_method": "tcp://nid:29511",
                      "world_size": 2, "rank": 1}]
    assert res["wireup"] == {"coordinator": "nid:29511", "num_processes": 2,
                             "process_id": 1, "local_device_count": None}
