# coding: utf-8
"""The one traffic generator: what a traffic file's parameters describe,
made from the run's seed.

Utterance durations are not drawn: every seed gets the same set, the
quantiles (i + 1/2) / n of the corpus's duration distribution, so the work
of a run does not depend on its seed. The seed draws what each utterance
says (words from words.txt, at the corpus's characters per second), its
speaker, and the order things come in."""

import math
from pathlib import Path

import numpy as np

WORDS = Path(__file__).resolve().parent / "traffic" / "words.txt"


def rng(seed, stream):
    """A numpy generator for one use of the run's seed (any whole number)."""
    return np.random.default_rng([int(seed) & (2 ** 63 - 1), stream])


def kumaraswamy_quantile(u, a, b):
    return (1.0 - (1.0 - u) ** (1.0 / b)) ** (1.0 / a)


def durations(corpus, n):
    """n utterance durations (s), ascending: the quantiles (i + 1/2) / n of
    a Kumaraswamy(a, b) law stretched over [min_s, max_s]."""
    u = (np.arange(n) + 0.5) / n
    q = kumaraswamy_quantile(u, corpus["shape_a"], corpus["shape_b"])
    return corpus["min_s"] + (corpus["max_s"] - corpus["min_s"]) * q


def words():
    return WORDS.read_text().split()


def text_of_length(r, vocab, n_chars):
    """A lowercase sentence of exactly n_chars characters ending in '.':
    whole words drawn from vocab, a comma now and then, the last word
    chosen to fill the length (words are never cut, so the English
    cleaners, which expand abbreviations before a '.', leave it alone)."""
    by_len = {}
    for w in vocab:
        by_len.setdefault(len(w), []).append(w)
    parts = []

    def used():
        return len(" ".join(parts)) + 1          # with the final '.'

    while n_chars - used() > 10 or not parts:
        w = vocab[r.integers(len(vocab))]
        if parts and r.random() < 0.08:
            parts[-1] += ","
        parts.append(w)
        if used() > n_chars and len(parts) > 1:
            parts.pop()
            break
    rem = n_chars - used()
    while rem > 0:
        k = min(rem - 1, max(by_len))
        if k < 1:                        # one character left: a comma
            parts[-1] += ","
            break
        pool = by_len.get(k)
        if pool is None:
            k = max(n for n in by_len if n <= k)
            pool = by_len[k]
        parts.append(pool[r.integers(len(pool))])
        rem = n_chars - used()
    return " ".join(parts) + "."


def utterances(traffic, seed, n):
    """n utterances (duration, text, speaker or None), ascending by
    duration."""
    r = rng(seed, 1)
    vocab = words()
    durs = durations(traffic["corpus"], n)
    cps = traffic["chars_per_second"]
    out = []
    for d in durs:
        text = text_of_length(r, vocab, max(2, int(round(d * cps))))
        spk = (int(r.integers(traffic["speakers"]))
               if traffic.get("speakers") else None)
        out.append((float(d), text, spk))
    return out


def decoder_steps(duration_s, hp):
    """Decoder steps that hold `duration_s` of audio: frames of hop samples,
    r * downsample_step of them a step."""
    per_step = hp["hop_size"] * hp["outputs_per_step"] * hp["downsample_step"]
    return int(math.ceil(duration_s * hp["sample_rate"] / per_step))


def synthesis_batches(traffic, seed, hp):
    """The pool sorted by duration and cut into batches, in an order drawn
    from the seed: [(texts, speaker ids or None, decoder steps)]."""
    utts = utterances(traffic, seed, traffic["pool"])
    B = traffic["batch"]
    batches = []
    for i in range(0, len(utts), B):
        part = utts[i:i + B]
        order = rng(seed, 2 + i).permutation(len(part))
        part = [part[j] for j in order]
        spk = None if part[0][2] is None else [u[2] for u in part]
        batches.append(([u[1] for u in part], spk,
                        decoder_steps(max(u[0] for u in part), hp)))
    order = rng(seed, 0).permutation(len(batches))
    return [batches[j] for j in order]


def sampled_calls(seed, n_calls, n_sample):
    """Which of the first n_calls calls of the window are kept for the
    output check."""
    return sorted(int(i) for i in rng(seed, 3).choice(
        n_calls, size=min(n_sample, n_calls), replace=False))


def arrivals(rate, seconds, seed):
    """Due offsets (s) of round(rate * seconds) open-loop arrivals at mean
    rate `rate`: a Poisson process whose gaps are the quantiles
    (i + 1/2) / n of Exp(rate), so every seed offers the same set of gaps
    and the same total length, in an order drawn from the seed. The first
    arrival is due at 0."""
    n = int(round(rate * seconds))
    gaps = -np.log(1.0 - (np.arange(n) + 0.5) / n) / rate
    gaps = gaps[rng(seed, 7).permutation(n)]
    return np.cumsum(gaps) - gaps[0]
