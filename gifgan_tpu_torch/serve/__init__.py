"""Serving: the GIF sampler, the explorer, webcam and survey services and
the browser export."""

import os

# the browser front ends (copies of gifgan_tpu/serve/static/): the
# explorer's index.html, the export's generator.js and draw.html
STATIC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "static")
