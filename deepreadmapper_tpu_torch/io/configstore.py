# Copied from deepreadmapper_tpu/io/configstore.py, the JAX-free host layer; kept in step with it.
"""Per-index config.txt store, on-disk compatible with the reference
(save_config/load_config, src/utils/utils.cpp:505-597).

Values are typed by parse order: unsigned integer, then float, then string —
exactly the reference's std::stoull -> std::stof -> string fallback.
"""

from __future__ import annotations

import os


def save_config(config: dict, folder_path: str, config_file: str = "config.txt") -> str:
    os.makedirs(folder_path, exist_ok=True)
    path = os.path.join(folder_path, config_file)
    with open(path, "w") as f:
        for key, value in config.items():
            f.write(f"{key}: {value}\n")
    return path


def _parse_value(s: str):
    # Parse order mirrors the reference: whole-string unsigned int, then
    # whole-string float, then raw string.
    try:
        v = int(s)
        if v >= 0:
            return v
    except ValueError:
        pass
    try:
        return float(s)
    except ValueError:
        return s


def load_config(config_path: str) -> dict:
    config: dict = {}
    with open(config_path) as f:
        for line in f:
            line = line.rstrip("\n")
            pos = line.find(":")
            if pos == -1:
                continue
            key = line[:pos].strip()
            value = line[pos + 1 :].strip()
            config[key] = _parse_value(value)
    return config
