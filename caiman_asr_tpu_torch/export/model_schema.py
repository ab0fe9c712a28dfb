"""Model schema gate (the port of ``caiman_asr_tpu/export/model_schema.py``;
reference export/model_schema/__init__.py:28-66).

The serving stack accepts only the exact base and large parameter layouts:
this gate compares a parameter tree's {name: shape} map with the stored
schemas (the port's own copies of the JAX package's
``export/schemas/{base,large}.json``, regenerated from the canonical
configs by ``python -m caiman_asr_tpu_torch.export.model_schema``).
"""

from __future__ import annotations

import json
from enum import Enum
from pathlib import Path
from typing import Dict, List

SCHEMA_DIR = Path(__file__).parent / "schemas"


class CheckpointNotSupportedError(Exception):
    pass


class ModelVariant(Enum):
    BASE = "base"
    LARGE = "large"


def return_schemas() -> List[dict]:
    return [json.loads((SCHEMA_DIR / f"{v.value}.json").read_text()) for v in ModelVariant]


def get_schema(params, prefix: str = "") -> Dict[str, list]:
    """{"a/b/c": shape} of a nested dict (or list) of arrays or tensors."""
    if isinstance(params, dict):
        items = params.items()
    elif isinstance(params, (list, tuple)):
        items = enumerate(params)
    else:
        return {prefix[:-1]: list(params.shape)}
    out = {}
    for k, v in items:
        out.update(get_schema(v, f"{prefix}{k}/"))
    return out


def check_model_schema(params, schemas: List[dict]):
    schema = get_schema(params)
    if sum(1 for s in schemas if s == schema) != 1:
        raise CheckpointNotSupportedError(
            "Model parameter shapes do not match any supported ModelVariant "
            f"({[v.name for v in ModelVariant]}).")


def check_schema_training(params, skip_state_dict_check: bool):
    try:
        check_model_schema(params, return_schemas())
    except CheckpointNotSupportedError as e:
        if not skip_state_dict_check:
            raise CheckpointNotSupportedError(
                str(e) + "\nPass --skip_state_dict_check to bypass (the model "
                "will not be loadable by the serving stack).")


def generate_schemas():
    """Rewrite the schema JSONs from the canonical configs (the CLI): each
    model is built on the meta device, so no weights are drawn."""
    from caiman_asr_tpu_torch.models.config import load_config
    from caiman_asr_tpu_torch.models.rnnt import RNNT

    SCHEMA_DIR.mkdir(exist_ok=True)
    for variant, cfg_path, n_classes in [("base", "configs/base-8703sp.yaml", 8704),
                                         ("large", "configs/large-17407sp.yaml", 17408)]:
        model = RNNT(load_config(cfg_path).rnnt, n_classes, device="meta")
        schema = get_schema(model.param_tree())
        (SCHEMA_DIR / f"{variant}.json").write_text(json.dumps(schema, indent=1))
        print(f"wrote {variant}.json ({len(schema)} tensors)")


if __name__ == "__main__":
    generate_schemas()
