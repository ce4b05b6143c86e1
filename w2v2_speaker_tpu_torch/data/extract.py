"""Archive extraction for ``prepare_data`` (raw corpus zips and tars to a
WAV tree): the port's copy of ``w2v2_speaker_tpu/data/extract.py``.

- ``vox1_dev_wav_parta*``-style split archives are concatenated into one
  ``.zip`` first (the official distribution splits the dev set);
- every ``*.zip`` / ``*.tar`` / ``*.tar.gz`` / ``*.tgz`` directly under the
  corpus root is extracted in place, once, marked by a
  ``.<name>.extracted`` file;
- ``effective_audio_root`` finds where the speaker tree lies after
  extraction (VoxCeleb archives nest it under ``wav/`` or ``aac/``).
"""

from __future__ import annotations

import pathlib
import shutil
import tarfile
import zipfile
from typing import List

__all__ = ["concatenate_parts", "extract_archives", "effective_audio_root"]


def concatenate_parts(root: pathlib.Path) -> List[pathlib.Path]:
    """Join `<name>_parta?`-style split archives into `<name>.zip`.

    Returns the list of archives assembled. The official VoxCeleb download
    page splits vox{1,2}_dev into parta..parth and instructs `cat * > x.zip`
    (mirrored by preparation_scripts/download_voxceleb{1,2}.sh).
    """
    root = pathlib.Path(root)
    groups = {}
    for p in sorted(root.glob("*_part??")) + sorted(root.glob("*_parta?")):
        stem = p.name.rsplit("_part", 1)[0]
        groups.setdefault(stem, []).append(p)
    made = []
    for stem, parts in groups.items():
        target = root / f"{stem}.zip"
        if target.exists():
            continue
        tmp = target.with_suffix(".zip.tmp")
        with open(tmp, "wb") as out:
            for part in sorted(set(parts)):
                with open(part, "rb") as f:
                    shutil.copyfileobj(f, out)
        tmp.rename(target)
        made.append(target)
    return made


def extract_archives(root: pathlib.Path) -> List[pathlib.Path]:
    """Extract every archive directly under `root`, once. Returns the list
    of archives extracted this call."""
    root = pathlib.Path(root)
    concatenate_parts(root)
    done = []
    archives = (
        sorted(root.glob("*.zip"))
        + sorted(root.glob("*.tar"))
        + sorted(root.glob("*.tar.gz"))
        + sorted(root.glob("*.tgz"))
    )
    for arc in archives:
        if arc.name.startswith("."):  # markers / hidden files
            continue
        marker = root / f".{arc.name}.extracted"
        if marker.exists():
            continue
        if arc.suffix == ".zip":
            with zipfile.ZipFile(arc) as z:
                z.extractall(root)
        else:
            # stdlib safe-extraction filter (refuses path traversal)
            with tarfile.open(arc) as t:
                t.extractall(root, filter="data")
        marker.touch()
        done.append(arc)
    return done


def effective_audio_root(root: pathlib.Path) -> pathlib.Path:
    """Where the `<spk>/<session>/<utt>.wav` tree lives under `root`.

    VoxCeleb archives nest it under `wav/` (or `aac/` for vox2); LibriSpeech
    tars nest under `LibriSpeech/<split>/`. If audio already sits directly
    under `root`, `root` is returned unchanged.
    """
    root = pathlib.Path(root)
    if any(root.glob("*/*/*.wav")) or any(root.glob("*/*/*.flac")):
        return root
    for nested in ("wav", "aac", "dev/wav", "test/wav"):
        cand = root / nested
        if cand.is_dir() and (
            any(cand.glob("*/*/*.wav")) or any(cand.glob("*/*/*.m4a"))
        ):
            return cand
    return root
