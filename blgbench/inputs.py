"""A cell's inputs, made from its configuration file and the seed.

A configuration of kind "bundle" lists assets (name, kind, bytes); one of
kind "textures" lists BCn textures (name, format, width, height, mips,
swizzle, delta). Both name the page size and, under "container", the
arguments of `brotlig_tpu_torch.encode` that make the containers a
loader reads, as the asset build made them offline.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass

from .data import assets, textures


@dataclass
class Item:
    name: str
    data: bytes                 # what the user wrote: the asset or texture
    dc: dict | None = None      # a texture's preconditioning, else None
    blob: bytes | None = None   # its container, where the traffic reads one


def texture_dc(t: dict) -> dict:
    """The DataConditionParams fields of a texture entry."""
    mips = t["mips"]
    if mips == "full":
        mips = textures.full_mips(t["width"], t["height"])
    return dict(precondition=True, swizzle=t["swizzle"],
                delta_encode=t["delta"],
                format=textures.FORMAT_CODES[t["format"]],
                width_in_pixels=t["width"], height_in_pixels=t["height"],
                num_mip_levels=mips)


def make_items(config: dict, seed: int, max_bytes: int | None = None):
    """The configuration's entries in file order, each made from the seed
    and its place in the file; entries above max_bytes are left out."""
    items = []
    if config["kind"] == "bundle":
        for i, a in enumerate(config["assets"]):
            if max_bytes is None or a["bytes"] <= max_bytes:
                items.append(Item(a["name"], assets.make_asset(
                    a["kind"], a["bytes"], seed, i)))
    elif config["kind"] == "textures":
        for i, t in enumerate(config["textures"]):
            dc = texture_dc(t)
            if max_bytes is not None and textures.texture_size(
                    t["format"], t["width"], t["height"],
                    dc["num_mip_levels"]) > max_bytes:
                continue
            items.append(Item(t["name"], textures.make_texture(
                t["format"], t["width"], t["height"],
                dc["num_mip_levels"], seed, i), dc))
    else:
        raise ValueError(f"configuration kind {config['kind']!r}")
    return items


def make_containers(items, config: dict, device: str) -> str:
    """Encode every item as the configuration's "container" says; returns
    the SHA-256 of all containers in order, so that a change to the
    encoder that made them shows."""
    import brotlig_tpu_torch as blg
    from brotlig_tpu_torch.format.precondition import DataConditionParams
    h = hashlib.sha256()
    for it in items:
        dc = None if it.dc is None else DataConditionParams(**it.dc)
        it.blob = blg.encode(it.data, page_size=config["page_size"],
                             dc_params=dc, device=device,
                             **config["container"])
        h.update(it.blob)
    return h.hexdigest()
