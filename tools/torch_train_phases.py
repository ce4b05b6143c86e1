"""The training phases of ``chip_smoke.py`` (6, 7, 10 and 11) of one checkout
of the PyTorch port, on one NVIDIA card.

    python3 tools/torch_train_phases.py [CHECKOUT]

``CHECKOUT`` (default: the checkout this file lives in) is the root of a
checkout of the repository, e.g. an older commit unpacked with
``git archive``; its ``chip_smoke.py`` and package are imported, so two
commits are compared by running this once per checkout within one call
(A, B, B, A). The checkout must compose its recipes from ``config/``
(``runtime.experiment.load_recipe``); an older one needs that function
patched in. Prints the phases' lines: the BASE and LARGE bf16 steps
(ms/step, peak memory, launches, device profile) and the float32
card-vs-CPU steps. Needs ``nvcc`` and one card.
"""

from __future__ import annotations

import pathlib
import sys

CHECKOUT = pathlib.Path(sys.argv[1] if len(sys.argv) > 1 else __file__).resolve()
if CHECKOUT.is_file():
    CHECKOUT = CHECKOUT.parent.parent
sys.path.insert(0, str(CHECKOUT))

import chip_smoke  # noqa: E402
from w2v2_speaker_tpu_torch.entry import large_train_entry  # noqa: E402
from w2v2_speaker_tpu_torch.runtime.experiment import load_recipe  # noqa: E402


def main() -> None:
    card = chip_smoke.card_line()
    print("checkout", CHECKOUT, card, flush=True)
    chip_smoke.set_float32_precision()
    chip_smoke.build_phase()
    chip_smoke.train_phase(card)  # 6
    chip_smoke.f32_train_phase()  # 7
    chip_smoke.train_phase(card, large_train_entry, "large train", conv_per_step=6)  # 10
    large = load_recipe("speaker_wav2vec2_large_aam", ["network.conv_impl=fused_pallas"])
    chip_smoke.f32_train_phase(large, "LARGE", conv_launches=6)  # 11


if __name__ == "__main__":
    main()
