"""Caption one image with any model and render the attention grid (the
reference's viz_scn / viz_attention / viz_attention_scn notebooks).

    python -m indonesian_image_captioning_tpu_torch.examples.caption_and_visualize \\
        -t attention_scn -i x.jpg -mc <ckpt> -wm WORDMAP.json \\
        [-tm TAGMAP.json] [-b 5]

Counterpart of the JAX repository's ``examples/caption_and_visualize.py``,
with the inference CLI's flags: a thin layer over ``cli/inference.run``
(``data/preprocess.read_image``, ``cli/common.load_caption_state``, the
beam decode with alphas and ``utils/visualize.visualize_att``), so the
decode path is the production one.  It runs on the card (``main(argv,
device=...)`` takes another device).
"""

from __future__ import annotations

from ..cli import inference


def main(argv=None, device="cuda"):
    result = inference.main(argv, device=device)
    print("\nresult:", {k: v for k, v in result.items() if k != "tags"})
    return result


if __name__ == "__main__":
    main()
