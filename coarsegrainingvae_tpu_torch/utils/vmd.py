"""VMD render-settings export (port of ``coarsegrainingvae_tpu.utils.vmd``).

The original code ships ``scripts/color.vmd``, a VMD session log whose
useful content is ~10 settings (white background, axes off, AOChalky
material, CPK/Licorice representation, orthographic view). This writes a
minimal script with the same settings, the same text as the JAX package's;
load it with ``vmd -e render.vmd`` after opening an exported .xyz/.pdb
(``utils/xyz.py``, ``utils/pdb.py``).
"""
from __future__ import annotations

_STYLES = {
    # style -> VMD representation command
    "cpk": "mol modstyle 0 top CPK 1.000000 0.300000 12.000000 12.000000",
    "licorice": "mol modstyle 0 top Licorice 0.300000 12.000000 12.000000",
    "vdw": "mol modstyle 0 top VDW 0.600000 12.000000",
}


def write_vmd_render_script(
    path: str,
    style: str = "cpk",
    background: str = "white",
    material: str = "AOChalky",
    orthographic: bool = True,
) -> str:
    """Write a VMD .vmd render-settings script; returns the path.

    Covers the settings the original color.vmd uses (its background,
    axes, material and CPK commands).
    """
    if style not in _STYLES:
        raise KeyError(f"unknown style {style!r}; have {sorted(_STYLES)}")
    lines = [
        "# render settings for CoarseGrainingVAE structure exports",
        "axes location Off",
        f"color Display Background {background}",
        "display depthcue off",
        "display shadows on",
        "display ambientocclusion on",
        _STYLES[style],
        f"mol modmaterial 0 top {material}",
    ]
    if orthographic:
        lines.append("display projection Orthographic")
    lines.append("scale by 1.2")
    text = "\n".join(lines) + "\n"
    with open(path, "w") as f:
        f.write(text)
    return path
