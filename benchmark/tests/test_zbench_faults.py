"""The check sees each fault a cell can have: a whole run (on the CPU, at a
tiny size, the look for a card skipped) with the timed path broken
underneath comes out not correct.  One cell runs on one card, so there is
no exchange between cards to leave out.  Also the control's readings: the
program's correct, the control's not."""

import numpy as np
import pytest
import torch

from benchmark import control, harness
from zbench_util import tiny_root


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("faults"), records=6, pool=3)


def run(tiny, cell):
    root, spec = tiny
    res, _ = harness.run_cell(spec, cell, 2**31 + 5, 0.4, False, "cpu",
                              root=root)
    return res


def test_sound_runs_are_correct(tiny):
    assert run(tiny, "kafka16k.consume")["correct"]
    assert run(tiny, "kafka16k.produce")["correct"]


# ---- decode ----

def test_decode_byte_altered_where_produced(tiny, monkeypatch):
    from zstdsharp_tpu_torch.decode import device_pipeline as dp

    orig = dp._fused_decode

    def altered(*a, **k):
        rows, bad = orig(*a, **k)
        rows[:, 0] ^= 1
        return rows, bad

    monkeypatch.setattr(dp, "_fused_decode", altered)
    res = run(tiny, "kafka16k.consume")
    assert not res["correct"] and res["failed"] > 0


def test_decode_half_the_batch_left_out(tiny, monkeypatch):
    from zstdsharp_tpu_torch.decode import device_pipeline as dp

    orig = dp.decode_batch_device
    monkeypatch.setattr(dp, "decode_batch_device", lambda frames, *a, **k:
                        orig(frames[:len(frames) // 2], *a, **k))
    assert not run(tiny, "kafka16k.consume")["correct"]


def test_decode_state_unchanged(tiny, monkeypatch):
    """Every call returns the first call's rows."""
    from zstdsharp_tpu_torch.decode import device_pipeline as dp

    orig, first = dp.decode_batch_device, []

    def stale(frames, *a, **k):
        if not first:
            first.append(orig(frames, *a, **k))
        return first[0]

    monkeypatch.setattr(dp, "decode_batch_device", stale)
    assert not run(tiny, "kafka16k.consume")["correct"]


# ---- encode ----

def test_encode_byte_altered_where_produced(tiny, monkeypatch):
    from zstdsharp_tpu_torch.ops import assemble

    orig = assemble.assemble

    def altered(*a, **k):
        rows, lens = orig(*a, **k)
        idx = torch.arange(rows.shape[0])
        rows[idx, (lens.long() - 1).clamp(min=0)] ^= 1
        return rows, lens

    monkeypatch.setattr(assemble, "assemble", altered)
    res = run(tiny, "kafka16k.produce")
    assert not res["correct"] and res["limits"]["frames_wrong"]["value"] > 0


def test_encode_half_the_batch_left_out(tiny, monkeypatch):
    from zstdsharp_tpu_torch.encode import device_pipeline as ep

    orig = ep.compress_batch_device
    monkeypatch.setattr(ep, "compress_batch_device", lambda recs, *a, **k:
                        orig(recs[:len(recs) // 2], *a, **k))
    res = run(tiny, "kafka16k.produce")
    assert not res["correct"] and res["limits"]["frames_missing"]["value"] > 0


def test_encode_state_unchanged(tiny, monkeypatch):
    from zstdsharp_tpu_torch.encode import device_pipeline as ep

    orig, first = ep.compress_batch_device, []

    def stale(recs, *a, **k):
        if not first:
            first.append(orig(recs, *a, **k))
        return first[0]

    monkeypatch.setattr(ep, "compress_batch_device", stale)
    assert not run(tiny, "kafka16k.produce")["correct"]


def test_encode_content_size_left_out(tiny, monkeypatch):
    """Frames that decode right but break the configuration's frame format
    (no content size in the header)."""
    from benchmark.planes.encode import raw_frame
    from zstdsharp_tpu_torch.encode import device_pipeline as ep

    def no_size(recs, *a, **k):
        # no content size; a window descriptor of 128 KB
        frames = [b"\x28\xb5\x2f\xfd\x00\x38" + raw_frame(r)[9:]
                  for r in recs]
        return frames, {"device_frames": 0, "host_frames": 0}

    monkeypatch.setattr(ep, "compress_batch_device", no_size)
    res = run(tiny, "kafka16k.produce")
    assert not res["correct"]
    assert res["limits"]["frames_off_config"]["value"] > 0
    assert res["limits"]["frames_wrong"]["value"] == 0


@pytest.mark.parametrize("cell", ["kafka16k.consume", "kafka16k.produce",
                                  "zfs128k.read", "zfs128k.write"])
def test_control_fails_program_passes(tiny, cell):
    root, spec = tiny
    for seed in (1, 2**32 + 7, 3):
        r = control.readings(spec, cell, seed, "cpu", root=root)
        assert r["program"]["correct"] and not r["control"]["correct"]
        wrong = r["control"]["limits"]["frames_wrong"]
        assert wrong["value"] > wrong["at_most"]
        assert r["program"]["limits"]["frames_wrong"]["value"] == 0


def test_decode_check_finds_one_bit():
    """One flipped bit in one frame of a batch is one frame wrong."""
    from benchmark.planes import decode

    contents = [bytes([i]) * (100 + i) for i in range(5)]
    rows = np.zeros((5, 104), np.uint8)
    for i, c in enumerate(contents):
        rows[i, :len(c)] = np.frombuffer(c, np.uint8)
    lengths = np.array([len(c) for c in contents])
    res = ([torch.from_numpy(rows)], lengths, {})
    assert decode.frames_wrong(contents, res) == 0
    rows[3, 50] ^= 4
    assert decode.frames_wrong(contents, res) == 1
    host = {2: contents[2]}
    dev_rows = torch.from_numpy(np.delete(rows, 2, axis=0))
    assert decode.frames_wrong(contents, ([dev_rows], np.delete(lengths, 2),
                                          host)) == 1
