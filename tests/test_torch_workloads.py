"""The port's workload traces equal the reference's.

Traces are pure numpy from one seeded generator, so for the same spec the
port's ``generate`` must give the reference's prompts, arrivals and
priorities, the same ``describe()`` fingerprint and the same requests,
for every family crossed with every arrival process and for each of
``smoke_specs``.
"""
import pytest

from repro_torch.serve import SamplingParams, WorkloadSpec, generate
from repro_torch.serve import smoke_specs
from repro_torch.serve.workloads import ARRIVALS, FAMILIES

BASE = dict(n_requests=12, vocab_size=50, seed=3, max_new=4, prefix_len=8,
            n_streams=3, suffix_lo=2, suffix_hi=5, priorities=(0, 1, 2))
CASES = ([(f"{f}-{a}", dict(BASE, name="t", family=f, arrival=a))
          for f in FAMILIES for a in ARRIVALS]
         + [(f"smoke-{i}", i) for i in range(3)]
         + [("sampled", dict(BASE, name="s", family="chat",
                             arrival="heavy-tail", temperature=0.7,
                             top_k=9, top_p=0.9, seed=2**33 + 5))])


def _request_fields(reqs):
    return [(r.rid, r.prompt, r.max_new, r.priority,
             None if r.sampling is None else r.sampling.describe())
            for r in reqs]


@pytest.mark.parametrize("case", [c for _, c in CASES],
                         ids=[name for name, _ in CASES])
def test_trace_equals_the_reference(case):
    pytest.importorskip("jax")
    from repro.serve import workloads as ref

    if isinstance(case, int):
        spec = smoke_specs(vocab_size=512, seed=7)[case]
        ref_spec = ref.smoke_specs(vocab_size=512, seed=7)[case]
    else:
        spec, ref_spec = WorkloadSpec(**case), ref.WorkloadSpec(**case)
    got, want = generate(spec), ref.generate(ref_spec)
    assert got.prompts == want.prompts
    assert got.arrivals == want.arrivals
    assert got.priorities == want.priorities
    assert got.describe() == want.describe()
    assert _request_fields(got.requests()) == _request_fields(
        want.requests())
    if spec.temperature > 0:
        assert isinstance(spec.sampling, SamplingParams)
