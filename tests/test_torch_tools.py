"""The port's test-run tool ``tools/xdist_blocks.py``: pytest-xdist's
initial blocks (``--dist load``) from a junit XML and a collection order."""

from distributed_tensorflow_examples_tpu_torch.tools import xdist_blocks


def test_initial_blocks_follow_the_load_scheduler(tmp_path, capsys):
    # 48 tests over 6 workers: blocks of (48 // 6) // 4 = 2 consecutive tests.
    seconds = [float(i) for i in range(48)]
    assert xdist_blocks.initial_blocks(seconds, 48, 6) == [1.0, 5.0, 9.0, 13.0, 17.0, 21.0]
    # 96: blocks of 4; the tests past the known 48 count 0.
    assert xdist_blocks.initial_blocks(seconds, 96, 6) == [6.0, 22.0, 38.0, 54.0, 70.0, 86.0]
    assert xdist_blocks.initial_blocks(seconds[:3], 3, 6)[0] == 1.0  # at least 2 a block
    cases = "".join(f'<testcase classname="tests.test_x" name="t{i}" time="{i}"/>'
                    for i in range(48))
    (tmp_path / "run.xml").write_text(f"<testsuites><testsuite>{cases}</testsuite></testsuites>")
    (tmp_path / "order.txt").write_text("".join(f"tests/test_x.py::t{i}\n" for i in range(48)))
    assert xdist_blocks.main([str(tmp_path / "run.xml"), str(tmp_path / "order.txt"),
                              "--span", "48"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("N 48, 1128.0 worker-seconds")
    assert "N 48: blocks of 2, the largest 21 s" in out and "N 96: blocks of 4" in out
