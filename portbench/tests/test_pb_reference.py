"""The plain reference and the frozen generator, on the CPU."""

import hashlib
import json
import os

import pytest

from portbench import lookup
from portbench.gen import streams
from portbench.reference import control, decode as ref

BENCH_MD5 = os.path.join(lookup.REPO, "broadway_tpu_torch", "tools", "data",
                         "bench_md5.json")


def _tiny_streams():
    with open(BENCH_MD5) as f:
        table = json.load(f)["streams"]
    return sorted((k, v) for k, v in table.items()
                  if v["args"]["width_mbs"] * v["args"]["height_mbs"] <= 108)


@pytest.mark.parametrize("name,entry", _tiny_streams(),
                         ids=[k for k, _ in _tiny_streams()])
def test_reference_matches_the_jax_packages_md5s(name, entry):
    """The frozen generator makes the same bytes (sha256) as the port's did
    for bench_md5.json, and the reference decodes them to the md5s that
    the JAX package's NumPy decoder gave (read as data, nothing
    imported)."""
    make = getattr(streams, entry["generator"].split()[-1])
    data, _ = make(**entry["args"])
    assert hashlib.sha256(data).hexdigest() == entry["sha256"]
    assert [ref.md5(p) for p in ref.decode_annexb(data)] == \
        entry["pictures"]


@pytest.mark.parametrize("config", ["story-360p", "cam-1080p"])
def test_pool_files_match_their_manifest(config):
    man = lookup.manifest(config)
    cfg = lookup.config(config)
    assert [g["args"]["seed"] for g in man["gops"]] == \
        cfg["generator"]["seeds"]
    for g in man["gops"]:
        data = lookup.gop_bytes(config, g)
        assert hashlib.sha256(data).hexdigest() == g["sha256"]
        assert dict(g["args"], seed=0) == \
            dict(cfg["generator"]["args"], seed=0)
        assert len(g["md5"]) == len(g["mb_classes"]) == \
            cfg["generator"]["args"]["n_frames"]


@pytest.mark.parametrize("config", ["story-360p", "cam-1080p"])
def test_pool_classes_match_the_references_parse(config):
    """The manifest's macroblocks by class (the roofline counts read them)
    are those that the reference's own parse finds in the first GOP."""
    g = lookup.manifest(config)["gops"][0]
    dec = ref.ReferenceDecoder(reconstruct=False)
    dec.feed(lookup.gop_bytes(config, g))
    assert dec.mb_classes == g["mb_classes"]


def test_pool_md5s_match_the_reference_on_a_gop_prefix():
    g = lookup.manifest("story-360p")["gops"][1]
    got = [ref.md5(p) for p in ref.decode_annexb(
        lookup.gop_bytes("story-360p", g), 3)]
    assert got == g["md5"][:3]


def test_control_fails_where_the_reference_passes():
    """The control (6-tap sums in float16) changes P pictures of the
    realistic content and leaves the IDR alone: it has to come out as
    not correct."""
    data, _ = streams.realistic_stream(8, 6, 4, seed=5, n_slices=2, gop=4)
    want = [ref.md5(p) for p in ref.decode_annexb(data)]
    got = [ref.md5(p) for p in control.decode_annexb(data)]
    assert got[0] == want[0]
    assert sum(a != b for a, b in zip(got, want)) >= 2


@pytest.mark.parametrize("cell", ["story-360p.procs6",
                                  "story-360p.lockstep6"])
def test_control_cli_reads_a_difference_on_the_360p_cell(capsys, cell):
    """The control's command on a 360p cell's live pictures, as the chip
    run reads it (a seed whose live GOP the test fixes by the plan)."""
    assert control.main(["--workload", cell, "--seed", "7"]) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["pictures"] == 4
    assert row["live_differing"] >= 1
    assert row["live_differing"] == row["differing_from_pool"]
