"""The port's write-ahead serve journal (``repro_torch.runtime.journal``)
against ``tests/test_recovery.py``'s journal unit tests, and against the
JAX package's journal (``repro.runtime.journal``): the same prompt
digests, and a journal written by either package replays identically in
the other (the line format is one, byte for byte). No model runs here.
"""

import json
import os
import zlib

import numpy as np
import pytest
import torch

from repro.runtime import journal as J
from repro_torch.runtime.journal import (ServeJournal, check_fingerprint,
                                         generator_state, prompt_digest,
                                         state_hex)


def test_journal_roundtrip_and_torn_tail(tmp_path):
    path = str(tmp_path / "j.jsonl")
    fp = {"journal_version": 1, "arch": "x", "sample": False}
    j = ServeJournal(path, fingerprint=fp)
    j.append({"t": "submit", "rid": "a", "i": 0, "digest": "d",
              "gen": 4, "arrival": 0, "priority": 0})
    j.append({"t": "progress", "rid": "a", "toks": [1, 2]})
    j.flush()
    j.append({"t": "progress", "rid": "a", "toks": [3, 4],
              "key": [7, 8]})
    j.append({"t": "complete", "rid": "a", "n": 4})
    j.close()

    rep = ServeJournal.replay(path)
    assert not rep.truncated
    assert rep.header["fingerprint"] == fp
    assert rep.submits["a"]["gen"] == 4
    assert rep.emitted["a"] == [1, 2, 3, 4]
    assert rep.keys["a"] == [7, 8]
    assert rep.completes["a"]["n"] == 4

    # a torn tail (half a line) stops replay at the durable prefix
    with open(path) as f:
        lines = f.read().splitlines()
    with open(path, "w") as f:
        f.write("\n".join(lines[:3]) + "\n")
        f.write(lines[3][: len(lines[3]) // 2])
    rep = ServeJournal.replay(path)
    assert rep.truncated
    assert rep.emitted["a"] == [1, 2]
    assert "a" not in rep.completes

    # a tampered but well-formed record fails its crc
    rec = json.loads(lines[2])
    rec["rec"]["toks"] = [9, 9]
    with open(path, "w") as f:
        f.write("\n".join(lines[:2]) + "\n")
        f.write(json.dumps(rec) + "\n")
    rep = ServeJournal.replay(path)
    assert rep.truncated and "a" not in rep.emitted


def test_journal_append_is_buffered_until_flush(tmp_path):
    path = str(tmp_path / "j.jsonl")
    j = ServeJournal(path, fingerprint={"journal_version": 1})
    j.wait()
    sz0 = os.path.getsize(path)
    j.append({"t": "progress", "rid": "a", "toks": [1]})
    assert os.path.getsize(path) == sz0             # not written yet
    j.flush()
    j.wait()
    assert os.path.getsize(path) > sz0
    j.close()


def test_fingerprint_mismatch_refuses_resume():
    fp = {"journal_version": 1, "arch": "a", "page_size": 128,
          "max_len": 64, "temperature": 0.0, "sample": False,
          "eos_id": None, "pad_id": 0, "key": None}
    check_fingerprint(fp, dict(fp))
    with pytest.raises(ValueError, match="temperature"):
        check_fingerprint(fp, dict(fp, temperature=0.5))
    with pytest.raises(ValueError, match="key"):
        check_fingerprint(fp, dict(fp, key=[1, "cpu"]))
    # a generator state is its device type's: cpu and cuda never resume
    with pytest.raises(ValueError, match="key"):
        check_fingerprint(dict(fp, key=[7, "cuda"]),
                          dict(fp, key=[7, "cpu"]))


def test_crc_line_format_stable(tmp_path):
    """The line is crc32 over the canonical JSON of the record."""
    path = str(tmp_path / "j.jsonl")
    j = ServeJournal(path)
    j.append({"t": "progress", "rid": "r", "toks": [5]})
    j.close()
    line = json.loads(open(path).read().splitlines()[0])
    canon = json.dumps(line["rec"], sort_keys=True, separators=(",", ":"))
    assert line["crc"] == zlib.crc32(canon.encode())


def test_prompt_digest_is_content_addressed():
    a = np.asarray([1, 2, 3], np.int32)
    assert prompt_digest(a) == prompt_digest([1, 2, 3])
    assert prompt_digest(a) != prompt_digest([1, 2, 4])


@pytest.mark.parametrize("n", [0, 1, 7, 144])
def test_prompt_digest_equals_the_jax_package(n):
    prompt = np.random.default_rng(n).integers(0, 152064, n)
    assert prompt_digest(prompt) == J.prompt_digest(prompt)
    assert prompt_digest(torch.as_tensor(prompt)) == J.prompt_digest(prompt)


def _write(journal_cls, path):
    """A serve-shaped journal: header, submits, batched progress with
    generator states, a complete, then a torn half line."""
    fp = {"journal_version": 1, "arch": "serveloop-smoke", "page_size": 128,
          "max_len": 128, "temperature": 0.8, "sample": True, "eos_id": None,
          "pad_id": 0, "key": [7, "cpu"]}
    j = journal_cls(path, fingerprint=fp)
    for i in range(3):
        j.append({"t": "submit", "rid": f"req-{i:06d}", "i": i,
                  "digest": J.prompt_digest([i, i + 1]), "gen": 4,
                  "arrival": i, "priority": i % 2})
    j.flush()
    j.append({"t": "progress", "d": {"req-000000": [5, 6],
                                     "req-000001": [9]},
              "k": {"req-000000": "00ff", "req-000001": "a1b2"}})
    j.append({"t": "complete", "rid": "req-000002", "n": 0,
              "admitted_step": 0, "finished_step": 4, "arrival": 2,
              "arrived_s": 0.5, "finished_s": 1.25, "first_token_s": 0.75,
              "priority": 0, "preemptions": 0})
    j.flush()
    j.append({"t": "progress", "rid": "req-000001", "toks": [3],
              "key": "c3d4"})
    j.close()
    with open(path, "a") as f:
        f.write('{"crc":1,"rec":{"t":"prog')


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_journal_replays_identically_across_packages(tmp_path, writer):
    port, ref = str(tmp_path / "port.jsonl"), str(tmp_path / "jax.jsonl")
    _write(ServeJournal, port)
    _write(J.ServeJournal, ref)
    assert open(port).read() == open(ref).read()    # one line format
    path = port if writer == "port" else ref
    mine, theirs = ServeJournal.replay(path), J.ServeJournal.replay(path)
    assert vars(mine) == vars(theirs)
    assert mine.truncated and mine.n_records == 7
    assert mine.emitted == {"req-000000": [5, 6], "req-000001": [9, 3]}
    assert mine.keys["req-000001"] == "c3d4"


def test_generator_state_round_trips_through_hex():
    """A generator's state survives the journal's hex string: the restored
    generator draws what the original draws next."""
    g = torch.Generator().manual_seed(3)
    torch.rand(5, generator=g)
    h = torch.Generator()
    h.set_state(generator_state(json.loads(json.dumps(
        state_hex(g.get_state())))))
    assert torch.equal(torch.rand(7, generator=g),
                       torch.rand(7, generator=h))
