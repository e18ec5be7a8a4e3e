"""The multi-rank surfaces as ``chip_smoke.py`` phase 12 drives them over
NCCL, one rank per card, here on the CPU.

Phase 12's own rank code (``chip_smoke.multicard_run``) runs in two spawned
gloo ranks at a small size (the dry run's model, a few frames), and its
gates hold every rank against this one process: clip-sharded stabilize in
every mode and ``stabilize_multi(mesh=)`` byte-equal, each rank writing its
own clips; temporal sharding byte-equal at the halo-equal chunk and a
larger one; two data-parallel runs byte-equal, the losses within the
reference's rtol 1e-5; tensor parallelism within 2e-5 and 1 LSB. Beside
it: a rank's card is its ``LOCAL_RANK``, also in spawned ranks whose
parent has one, and a card the process cannot see raises.
"""

import numpy as np
import pytest
import torch

import chip_smoke
import torch_ranks
from dvsg_tpu_torch.config import TrainConfig
from dvsg_tpu_torch.parallel import dryrun
from dvsg_tpu_torch.parallel import mesh as mesh_lib
from dvsg_tpu_torch.utils import checkpoint as ckpt


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cards(monkeypatch):
    """A process that sees four cards (device resolution only)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)


def test_rank_device_is_the_local_rank_card(cards, monkeypatch):
    for k in range(4):
        monkeypatch.setenv("LOCAL_RANK", str(k))
        assert mesh_lib.rank_device("cuda") == torch.device("cuda", k)
        assert mesh_lib.rank_device() == torch.device("cuda", k)
    assert mesh_lib.rank_device("cuda:1") == torch.device("cuda", 1)
    assert mesh_lib.rank_device("cpu") == torch.device("cpu")
    monkeypatch.delenv("LOCAL_RANK")
    assert mesh_lib.rank_device("cuda") == torch.device("cuda", 0)


def test_a_card_out_of_sight_raises(cards, monkeypatch):
    monkeypatch.setenv("LOCAL_RANK", "4")
    with pytest.raises(RuntimeError, match="sees 4 card"):
        mesh_lib.rank_device("cuda")
    monkeypatch.setenv("LOCAL_RANK", "0")
    with pytest.raises(RuntimeError, match="one rank\\s+per visible card"):
        mesh_lib.rank_device("cuda:7")


def test_init_distributed_drives_the_local_rank_card(cards, monkeypatch):
    seen, set_to = [], []
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda backend, **kw: seen.append((backend, kw)))
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: False)
    monkeypatch.setattr(torch.cuda, "set_device", set_to.append)
    for k, v in dict(MASTER_ADDR="localhost", WORLD_SIZE="8", RANK="6",
                     LOCAL_RANK="2").items():
        monkeypatch.setenv(k, v)
    assert mesh_lib.init_distributed(device="cuda") == "nccl"
    assert seen[-1][1]["init_method"] == "env://"
    assert set_to == [torch.device("cuda", 2)]
    # Joining from a coordinator: the card is still LOCAL_RANK's, not the
    # global rank's.
    assert mesh_lib.init_distributed("10.0.0.1:1234", num_processes=8,
                                     process_id=5, device="cuda") == "nccl"
    assert set_to[-1] == torch.device("cuda", 2)


def test_spawned_ranks_are_local_whatever_the_parent_says(monkeypatch,
                                                          tmp_path):
    # A LOCAL_RANK inherited from the spawning process (itself started by
    # torchrun) put every spawned rank on the parent's card.
    monkeypatch.setenv("LOCAL_RANK", "3")
    ranks = torch_ranks.spawn("local", 2, tmp_path, {})
    assert [(r["local"], r["env"]) for r in ranks] == [(0, "0"), (1, "1")]


def test_many_groups_join_at_once(tmp_path):
    """Six 2-rank gloo groups spawned at once, each rank leaving as soon as
    it has joined: every group joins and returns. A rank whose
    ``init_process_group`` returned first used to close the connection
    its peer was still handshaking on ("Gloo connectFullMesh failed ...
    Connection closed by peer", 4 of 180 such groups on a loaded host);
    ``dryrun.join_group`` now returns only when the whole group has
    joined."""
    import concurrent.futures
    with concurrent.futures.ThreadPoolExecutor(6) as ex:
        groups = list(ex.map(lambda i: torch_ranks.spawn(
            "local", 2, tmp_path / f"g{i}", {}), range(6)))
    assert [[r["local"] for r in g] for g in groups] == [[0, 1]] * 6


def test_two_dp_runs_over_four_ranks_give_the_same_bytes(tmp_path):
    mcfg, params = dryrun.tiny_setup()
    tcfg = TrainConfig(model=mcfg, batch_size=8, steps=10, warmup_steps=1,
                       learning_rate=1e-3)
    ranks = torch_ranks.spawn("dp_twice", 4, tmp_path, dict(
        tcfg=tcfg, tparams=params, steps=3))
    first = ranks[0][0]
    assert all(np.isfinite(first[0]))
    for runs in ranks:
        assert runs[0] == runs[1] == first


def _small_spec(npz: str) -> chip_smoke.MultiCard:
    # The dry run's model: window 3, so a 4-frame chunk over two ranks is
    # the halo-equal boundary, as T = 16 over four ranks is at full width.
    return chip_smoke.MultiCard(
        presets=(("tiny", npz),), device="cpu", backend="gloo", height=32,
        width=40, chunk=4, clips=4, clip_frames=6, long_frames=10,
        temporal_chunks=(4, 8), smooth=8, lag=2, steps=3, batch=4,
        tp_windows=2)


@pytest.fixture(scope="module")
def small_run(tmp_path_factory):
    """Phase 12's (a)-(d) over two gloo ranks at the small size: (spec, B1
    launches, B2/B3 launches, results, and what its gates read: one
    process's references and every rank's results)."""
    d = tmp_path_factory.mktemp("p12")
    mcfg, params = dryrun.tiny_setup()
    npz = str(d / "tiny.npz")
    ckpt.export_npz(npz, params, mcfg)
    spec = _small_spec(npz)
    seen, real = {}, chip_smoke.p12_check

    def keep(spec_, n, refs, ranks):
        seen.update(refs=refs, ranks=ranks)
        return real(spec_, n, refs, ranks)
    chip_smoke.p12_check = keep
    try:
        out = chip_smoke.multicard_run(spec, 2, torch.device("cpu"),
                                       str(d), seed=0)
    finally:
        chip_smoke.p12_check = real
    return (spec, *out, seen["refs"], seen["ranks"])


def test_phase12_rank_code_at_a_small_size(small_run):
    _, b1, train_counts, res, _, _ = small_run
    # The CPU runs every kernel's plain version: no launch is counted.
    assert b1 == 0 and set(train_counts.values()) == {0}
    tiny = res["tiny"]
    assert [tiny[f"rank{r}"]["device"] for r in range(2)] == ["cpu"] * 2
    assert set(tiny["rank0"]["temporal"]) == {
        f"{m}_T{t}" for m in ("plain", "causal") for t in (4, 8)}
    assert set(tiny["rank0"]["tp"]) == {"1x2", "2x1"}
    assert tiny["rank0"]["tp"]["1x2"]["gathers"] > 0
    assert tiny["rank0"]["tp"]["2x1"]["gathers"] == 0
    for r in range(2):
        t = tiny[f"rank{r}"]["temporal"]["plain_T4"]
        assert t["ring_calls"] == 3 and t["gather_calls"] == 3
        assert max(tiny[f"rank{r}"]["dp_loss_rel"]) <= chip_smoke.DP_LOSS_RTOL
    assert tiny["dp_grad_rel"] <= chip_smoke.DP_GRAD_TOL
    assert tiny["one_card"]["train_steps_per_s"] > 0


@pytest.mark.parametrize("where,edit", [
    ("sharded lag clip 1",
     lambda g: g["sharded"]["lag"]["hashes"][1].__setitem__(0, "0" * 40)),
    ("temporal causal_T4",
     lambda g: g["temporal"]["causal_T4"]["hashes"].__setitem__(2, "0")),
    ("second run", lambda g: g["dp"][1].__setitem__("digest", "x")),
    ("wrote clips",
     lambda g: g["sharded"]["multi_plain"]["hashes"].__setitem__(3, [])),
    ("TP 1x2", lambda g: g["tp"]["1x2"].__setitem__("lsb", 2))])
def test_phase12_gates_catch_a_rank_that_differs(small_run, where, edit):
    """A frame, a second DP run, a clip written by the wrong rank or a TP
    chunk 2 LSB off is a gate phase 12 misses."""
    import copy
    spec, _, _, _, refs, ranks = small_run
    assert chip_smoke.p12_check(spec, 2, refs, ranks)[3] == []
    ranks = copy.deepcopy(ranks)
    edit(ranks[0]["tiny"])
    fails = chip_smoke.p12_check(spec, 2, refs, ranks)[3]
    assert fails and where in fails[0], fails
