"""The committed ``results/bench_ckpt_torch.pt`` is the trained ego checkpoint.

It must equal a fresh export of the orbax ``results/bench_ckpt``
(``tests/torch_export_bench_ckpt.py``) tensor by tensor, exactly, and load
into the port's full-width ego with ``strict=True``: the torch bench
(``pcp_tpu_torch/bench.py``) and ``chip_smoke.py`` read it on the card,
where orbax is absent, so the copy must not go stale.
"""
import torch

from pcp_tpu_torch.bench import CKPT, load_trained_ego
from torch_export_bench_ckpt import TARGET, export_state_dict


def test_committed_copy_equals_a_fresh_export():
    assert CKPT == TARGET
    committed = torch.load(CKPT, map_location="cpu", weights_only=True)
    fresh = export_state_dict()
    assert list(committed) == list(fresh)
    for name, want in fresh.items():
        got = committed[name]
        assert got.dtype == want.dtype and got.shape == want.shape, name
        assert torch.equal(got, want), name
    assert {v.dtype for v in committed.values()} == {torch.float32, torch.int64}


def test_loads_into_the_ports_ego_strictly():
    _, _, model = load_trained_ego(device="cpu")
    sd = model.state_dict()
    committed = torch.load(CKPT, map_location="cpu", weights_only=True)
    assert set(sd) == set(committed)
    for name, value in committed.items():
        assert torch.equal(sd[name], value), name
    assert not model.training
