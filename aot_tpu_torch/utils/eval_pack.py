"""Submission packaging (reference: utils/eval.py:5-13)."""

import os
import zipfile


def zip_folder(source_folder: str, zip_path: str) -> None:
    with zipfile.ZipFile(zip_path, "w", zipfile.ZIP_DEFLATED) as zf:
        for root, _dirs, files in os.walk(source_folder):
            for f in files:
                full = os.path.join(root, f)
                rel = os.path.relpath(full, source_folder)
                zf.write(full, rel)
