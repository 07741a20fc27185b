"""The port's three paper examples (``src/repro_torch/examples``), run end to
end through their ``main`` on the CPU (``--device cpu``), the training ones
with their steps cut through ``--steps``; and their default device, the
card, which they refuse to replace with the CPU when none is visible."""

import pytest
import torch

from repro_torch.examples import cnn_im2col, gru_rnn, quickstart

torch.set_num_threads(2)


def _run(capsys, main, *args):
    main(["--device", "cpu", *args])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-1] == "OK"
    return lines


def test_quickstart(capsys):
    out = _run(capsys, quickstart.main)
    assert out[0].startswith("density after BCR projection: 0.1250")
    assert any(ln.startswith("BCRC index overhead") for ln in out)


def test_gru_rnn(capsys):
    out = _run(capsys, gru_rnn.main, "--steps", "3")
    assert "step 1: BCR masks frozen (10x), retraining" in out
    steps = [ln for ln in out if "GRU step (batch 32)" in ln]
    assert len(steps) == 2 and all("host CPU wall" in ln for ln in steps)
    bound = [ln for ln in out if ln.startswith("H100 byte bound")]
    assert len(bound) == 1 and "no card in this run" in bound[0]
    assert not any("v5e" in ln for ln in out)


def test_cnn_im2col(capsys):
    out = _run(capsys, cnn_im2col.main, "--steps", "9")
    acc = next(ln for ln in out if ln.startswith("accuracy with 4x BCR"))
    assert float(acc.split()[-1]) > 0.8
    assert any(ln.startswith("im2col skip:") for ln in out)


@pytest.mark.parametrize("main", [quickstart.main, gru_rnn.main,
                                  cnn_im2col.main],
                         ids=["quickstart", "gru_rnn", "cnn_im2col"])
def test_examples_default_to_the_card(main):
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is usable")
    with pytest.raises(RuntimeError):
        main([])
