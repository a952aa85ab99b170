"""The traffic generator: the frozen copy of the paper's draws, and the
same work for every run seed."""
import numpy as np
import pytest

from cardbench.core import registry
from cardbench.core import traffic as T


def _mix(name):
    return registry.load_json(registry.BENCH_DIR / "traffic" / f"{name}.json")


@pytest.mark.parametrize("seed", [0, 2**31 + 17])
def test_chat_draws_match_generate_workload(seed):
    from repro_torch.cluster.workload import generate_workload
    mix = _mix("chat")
    n = 500
    ours = T.draw_pool(mix, n, seed, mix["nominal_rate_per_s"])
    theirs = generate_workload(n_services=n, rate=mix["nominal_rate_per_s"],
                               seed=seed)
    assert ours["prompt"].tolist() == [s.prompt_tokens for s in theirs]
    assert ours["output"].tolist() == [s.output_tokens for s in theirs]
    np.testing.assert_array_equal(ours["deadline"],
                                  [s.deadline for s in theirs])
    np.testing.assert_array_equal(ours["arrival"],
                                  [s.arrival for s in theirs])


def test_docqa_lengths_in_range():
    mix = _mix("docqa")
    pool = T.draw_pool(mix, 4000, 3, 4.0)
    assert pool["prompt"].min() >= 512 and pool["prompt"].max() <= 3968
    assert 1500 < np.median(pool["prompt"]) < 1800
    assert pool["output"].min() >= 4 and pool["output"].max() <= 96
    assert (pool["deadline"] >= 2).all() and (pool["deadline"] <= 6).all()


def test_open_loop_schedule():
    mix = _mix("docqa")
    sched = T.open_schedule(mix, 4.0, 45.0)
    n = int(4.0 * (mix["lead_in_s"] + 45.0 + mix["tail_s"] + 2.0) * 1.5) + 64
    pool = T.draw_pool(mix, n, mix["pool_seed"], 4.0)
    k = len(sched)
    assert [i.offset for i in sched] == pool["arrival"][:k].tolist()
    assert [i.prompt_len for i in sched] == pool["prompt"][:k].tolist()
    span = mix["lead_in_s"] + 45.0 + mix["tail_s"]
    assert span < sched[-1].offset < span + 2.0
    window = [i for i in sched
              if mix["lead_in_s"] <= i.offset < mix["lead_in_s"] + 45.0]
    assert 150 < len(window) < 210           # Poisson at 4/s over 45 s
    assert T.open_schedule(mix, 4.0, 45.0) == sched


def test_closed_loop_lists():
    c = _mix("chat")["clients"]
    mix = dict(_mix("chat"), pool_size=20 * c)
    lists = T.closed_lists(mix)
    assert len(lists) == c and all(len(x) == 20 for x in lists)
    assert [i.idx for i in lists[3]] == list(range(3, 20 * c, c))
    assert all(i.client == c for c, lst in enumerate(lists) for i in lst)


def test_prompt_ids_depend_on_seed_and_item_only():
    it = T.Item(idx=5, prompt_len=40, max_new=4, deadline=3.0)
    assert T.prompt_ids(9, it, 1000) == T.prompt_ids(9, it, 1000)
    assert T.prompt_ids(9, it, 1000) != T.prompt_ids(10, it, 1000)
    assert all(0 <= t < 1000 for t in T.prompt_ids(2**40, it, 1000))


def test_warm_lengths_cover_the_buckets():
    assert T.warm_lengths(_mix("chat")) == [32, 64, 128, 256, 512, 1024,
                                            2048]
    assert T.warm_lengths(_mix("docqa")) == [512, 1024, 2048, 3968]
