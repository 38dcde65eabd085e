"""tools/length_trains.py tests."""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))

from length_trains import extract, parse_trace_line


def test_parse_trace_line():
    line = "1 0.0 10.0.0.1 -> 10.0.0.2 TCP 74 443->5555 [ACK] Seq=1 Len=287"
    src, dst, ln = parse_trace_line(line)
    assert src == "10.0.0.1"
    assert ln == 287


def test_extract_directions(tmp_path):
    d = tmp_path / "trace"
    d.mkdir()
    flow = d / "10.0.0.1-10.0.0.2-4444-443"
    flow.write_text(
        "1 0.0 10.0.0.1 -> 10.0.0.2 TCP 74 x [SYN] Len=40\n"
        "2 0.1 10.0.0.2 -> 10.0.0.1 TCP 74 x [ACK] Len=32\n"
        "3 0.2 10.0.0.1 -> 10.0.0.2 TCP 74 x [PSH] Len=287\n"
    )
    out = tmp_path / "out"
    out.mkdir()
    tx, rx, txrx = extract(str(d), str(out))
    assert open(tx).read().strip() == "40, 287"
    assert open(rx).read().strip() == "32"
    assert open(txrx).read().strip() == "40, -32, 287"
    # txrx trains feed straight into flow-line parsing (negatives allowed)
    from pattern_matching.core.patterns import parse_flow_line

    vals = parse_flow_line(open(txrx).read())
    assert vals[0] == 40
