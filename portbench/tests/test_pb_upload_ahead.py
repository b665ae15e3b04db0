"""The reader of ``upload_ahead_share`` (``metrics/upload_ahead_share.py``)
against made-up ``program`` counters of two clients: the share of
uploads made ahead of the graph's previous one, summed over the clients,
and None wherever a client sent no counters, no spans, or counters of a
program that does not count ``graph.upload_ahead``."""

import pytest

from portbench import lookup

SPANS = [["graph.sync", "bw-pump_0", 1, 2]]


def _run(*counters):
    return {"clients": [{"program": {"counters": dict(c),
                                     "spans": list(SPANS)}}
                        for c in counters]}


def _counters(uploads, blocked, ahead):
    return {"graph.uploads": uploads, "graph.sync_blocked": blocked,
            "graph.upload_ahead": ahead}


@pytest.mark.parametrize("name", ["upload_ahead_share",
                                  "upload_ahead_share.cam"])
@pytest.mark.parametrize("counters,want", [
    ((_counters(10, 3, 6), _counters(30, 0, 2)), 100.0 * 8 / 40),
    ((_counters(10, 0, 10),), 100.0),
    ((_counters(10, 10, 0), _counters(5, 5, 0)), 0.0),
])
def test_the_share_sums_over_the_clients(name, counters, want):
    reader = lookup.metric(name)
    assert reader.UNIT == "%"
    assert reader.read(_run(*counters)) == pytest.approx(want)


@pytest.mark.parametrize("how", ["no_program", "no_counters", "no_spans",
                                 "not_counted", "no_uploads"])
def test_none_where_a_client_sent_nothing_to_read(how):
    r = _run(_counters(10, 3, 6), _counters(30, 0, 2))
    second = r["clients"][1]
    if how == "no_program":
        second["program"] = None
    elif how == "no_counters":
        second["program"]["counters"] = {}
    elif how == "no_spans":
        second["program"]["spans"] = []
    elif how == "not_counted":          # a program without the counter
        del second["program"]["counters"]["graph.upload_ahead"]
    else:
        for c in r["clients"]:
            c["program"]["counters"] = _counters(0, 0, 0)
    assert lookup.metric("upload_ahead_share").read(r) is None
