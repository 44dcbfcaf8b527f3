"""URL helpers for inference on remote images (reference utils/url.py:11-43).

The port's copy of the JAX package's ``utils/url.py``.
"""

from __future__ import annotations

import os
import uuid
from io import BytesIO
from urllib.parse import urlparse
from urllib.request import urlopen


def is_absolute_path(url: str) -> bool:
    return bool(urlparse(url).netloc)


def download_file(url: str, temp_dir: str = "./temp") -> str:
    os.makedirs(temp_dir, exist_ok=True)
    file_name = os.path.join(temp_dir, uuid.uuid4().hex + ".jpg")
    with urlopen(url) as response, open(file_name, "wb") as out:
        out.write(response.read())
    return file_name


def read_image_from_url(url: str) -> BytesIO:
    with urlopen(url) as response:
        return BytesIO(response.read())
