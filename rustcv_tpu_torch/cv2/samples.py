"""cv2.samples role: sample-data file lookup."""
import os

_paths = []


def addSamplesDataSearchPath(path):
    _paths.insert(0, str(path))


def addSamplesDataSearchSubDirectory(subdir):
    _paths.append(str(subdir))


def findFile(relative_path, required=True, silentMode=False):
    if os.path.exists(relative_path):
        return relative_path
    for p in _paths:
        cand = os.path.join(p, relative_path)
        if os.path.exists(cand):
            return cand
    if required:
        raise FileNotFoundError(relative_path)
    return ""


def findFileOrKeep(relative_path, silentMode=False):
    out = findFile(relative_path, required=False, silentMode=silentMode)
    return out or relative_path
