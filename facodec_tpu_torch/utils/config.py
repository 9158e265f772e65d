"""YAML config loading with attribute-dict access.

A copy of facodec_tpu/utils/config.py: it reads the reference FAcodec
`configs/config.yml` schema unchanged. `yaml` is imported by `load_config`
alone, so that the package imports where pyyaml is not installed; there the
callers build from the module fields of `facodec_tpu_torch.config`, or
write the same schema as a `.json` file, which `load_config` reads with the
json module (JSON is a subset of YAML, so pyyaml reads such a file alike).
"""

from __future__ import annotations

from typing import Any


class AttrDict(dict):
    """dict with attribute access (a stand-in for `munch.Munch`)."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __delattr__(self, name: str) -> None:
        try:
            del self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def get(self, key, default=None):
        return dict.get(self, key, default)


def recursive_attrdict(d: Any) -> Any:
    """Recursively convert nested dicts/lists into AttrDicts."""
    if isinstance(d, dict):
        return AttrDict((k, recursive_attrdict(v)) for k, v in d.items())
    if isinstance(d, (list, tuple)):
        return [recursive_attrdict(v) for v in d]
    return d


def load_config(path: str) -> AttrDict:
    if path.endswith(".json"):
        import json

        with open(path, "r") as f:
            return recursive_attrdict(json.load(f))
    try:
        import yaml
    except ImportError as e:
        raise ImportError(
            f"load_config({path!r}) needs pyyaml, which is not installed; build "
            f"from the fields in facodec_tpu_torch.config instead") from e
    with open(path, "r") as f:
        cfg = yaml.safe_load(f)
    return recursive_attrdict(cfg)
