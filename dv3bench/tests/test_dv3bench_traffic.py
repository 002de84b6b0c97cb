# coding: utf-8
"""The generator: the same seed gives the same pool, batches and order;
every seed gets the same sizes; texts are ones the port's frontend and the
reference read alike."""

import torch

from conftest import ROOT, small_traffic, tiny_hp
from dv3bench import bench, generate
from dv3bench.kinds import train_step
from dv3bench.reference import text as ref_text

SEEDS = (2 ** 31 + 11, 5, 3000000019)


def _traffic(name):
    return bench.load_json(ROOT / "dv3bench" / "traffic" / (name + ".json"))


def _hp(config):
    return bench.load_json(ROOT / "dv3bench" / "configs" / (config + ".json"))


def test_same_seed_same_batches_every_seed_same_sizes():
    for traffic, config in (("ljspeech_batch32", "dv3_ljspeech"),
                            ("vctk_batch32", "dv3_vctk")):
        tr, hp = _traffic(traffic), _hp(config)
        a = generate.synthesis_batches(tr, SEEDS[0], hp)
        assert a == generate.synthesis_batches(tr, SEEDS[0], hp)
        sizes = None
        for seed in SEEDS:
            b = generate.synthesis_batches(tr, seed, hp)
            assert len(b) == tr["pool"] // tr["batch"]
            got = sorted((steps, tuple(sorted(len(t) for t in texts)))
                         for texts, _, steps in b)
            assert sizes is None or got == sizes
            sizes = got
        assert generate.synthesis_batches(tr, SEEDS[1], hp) != a


def test_texts_read_alike_by_port_and_reference():
    from deepvoice3_pytorch_tpu_torch.frontend import en
    tr = _traffic("ljspeech_batch32")
    for seed in SEEDS:
        for d, text, _ in generate.utterances(tr, seed, 256):
            assert len(text) == max(2, round(d * tr["chars_per_second"]))
            assert list(en.text_to_sequence(text)) == \
                ref_text.text_to_ids(text)


def test_durations_follow_the_corpus():
    for traffic in ("ljspeech_batch32", "vctk_batch32"):
        c = _traffic(traffic)["corpus"]
        d = generate.durations(c, 512)
        assert c["min_s"] <= d.min() and d.max() <= c["max_s"]
        assert abs(d.mean() - c["mean_s"]) < 0.15 * c["mean_s"]


def test_decoder_steps_hold_the_duration():
    hp = _hp("dv3_ljspeech")
    per_step = hp["hop_size"] * hp["outputs_per_step"] * hp["downsample_step"]
    for d in (1.1, 3.0, 10.1):
        n = generate.decoder_steps(d, hp)
        assert (n - 1) * per_step < d * hp["sample_rate"] <= n * per_step


def test_train_batches_same_seed_same_tensors():
    hp, tr = tiny_hp("dv3_vctk"), small_traffic("vctk_train16")
    a = train_step.make_batches(tr, SEEDS[0], hp, "cpu")
    b = train_step.make_batches(tr, SEEDS[0], hp, "cpu")
    c = train_step.make_batches(tr, SEEDS[1], hp, "cpu")
    for x, y, z in zip(a, b, c):
        assert x.keys() == y.keys()
        assert all(torch.equal(x[k], y[k]) for k in x)
        assert {k: v.shape for k, v in x.items()} == \
            {k: v.shape for k, v in z.items()}
    rows = [tuple(r.tolist()) for bt in a for r in bt["x"]]
    assert len(set(rows)) == len(rows)          # every row differs
