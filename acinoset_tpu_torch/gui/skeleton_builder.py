"""Skeleton authoring, the counterpart of acinoset_tpu.gui.skeleton_builder
(the reference's Tk skeleton-builder app, AcinoSet src/gui.py, and
test.py's pickle patch utilities): the programmatic ``SkeletonBuilder``
is the primary interface; ``launch_gui()`` is a small Tk front-end when
a display is available (tkinter, of the standard library, is imported
only there).

Skeleton dict schema (skeletons/*.pickle), the dict that
``models.skeleton.build_skeleton_model`` takes:
    {links: [[parent, child], ...], dofs: {part: [x, y, z]},
     positions: {part: [x, y, z]}, markers: [part, ...]}
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from ..pipeline import data as data_io


class SkeletonBuilder:
    """Fluent builder for skeleton dictionaries."""

    def __init__(self):
        self.positions: Dict[str, List[float]] = {}
        self.dofs: Dict[str, List[int]] = {}
        self.links: List[List[str]] = []
        self.markers: List[str] = []

    def add_part(self, name: str, position: Sequence[float], dofs: Sequence[int] = (0, 0, 0),
                 marker: bool = True) -> "SkeletonBuilder":
        """Add a body part at a rest position with per-axis rotation DoFs."""
        assert name not in self.positions, f"duplicate part {name}"
        self.positions[name] = [float(v) for v in position]
        self.dofs[name] = [int(bool(v)) for v in dofs]
        if marker:
            self.markers.append(name)
        return self

    def link(self, parent: str, child: str) -> "SkeletonBuilder":
        """Connect child to parent (rigid offset = rest-position delta)."""
        for p in (parent, child):
            assert p in self.positions, f"unknown part {p}"
        self.links.append([parent, child])
        return self

    def set_dofs(self, name: str, dofs: Sequence[int]) -> "SkeletonBuilder":
        self.dofs[name] = [int(bool(v)) for v in dofs]
        return self

    def build(self) -> Dict:
        return dict(
            links=[list(lk) for lk in self.links],
            dofs=dict(self.dofs),
            positions={k: list(v) for k, v in self.positions.items()},
            markers=list(self.markers),
        )

    def save(self, fpath: str) -> Dict:
        skel = self.build()
        data_io.save_skeleton(fpath, skel)
        return skel

    def validate(self) -> List[str]:
        """Structural checks; returns a list of problems (empty = OK)."""
        problems = []
        linked = {p for lk in self.links for p in lk}
        for p in self.positions:
            if p not in linked and len(self.positions) > 1:
                problems.append(f"part '{p}' is not linked")
        roots = {lk[0] for lk in self.links} - {lk[1] for lk in self.links}
        if self.links and len(roots) != 1:
            problems.append(f"expected exactly one root, found {sorted(roots)}")
        return problems


def patch_markers(skeleton_fpath: str, markers: List[str], out_fpath: Optional[str] = None):
    """Overwrite a skeleton pickle's markers list (the repo-root test.py
    utility, test.py:4-27)."""
    skel = data_io.load_skeleton(skeleton_fpath)
    skel["markers"] = list(markers)
    data_io.save_skeleton(out_fpath or skeleton_fpath, skel)
    return skel


def launch_gui(project_dir: str = "."):
    """Interactive Tk skeleton builder (needs a display)."""
    import tkinter as tk
    from tkinter import messagebox, simpledialog

    builder = SkeletonBuilder()
    root = tk.Tk()
    root.title("acinoset skeleton builder")
    listbox = tk.Listbox(root, width=60, height=20)
    listbox.pack(padx=8, pady=8)

    def refresh():
        listbox.delete(0, tk.END)
        for name, pos in builder.positions.items():
            listbox.insert(tk.END, f"{name}  pos={pos}  dofs={builder.dofs[name]}")
        for a, b in builder.links:
            listbox.insert(tk.END, f"  link {a} -> {b}")

    def add_part():
        name = simpledialog.askstring("Part", "name:")
        if not name:
            return
        pos = simpledialog.askstring("Part", "position x,y,z:", initialvalue="0,0,0")
        dof = simpledialog.askstring("Part", "dofs x,y,z (0/1):", initialvalue="0,1,0")
        builder.add_part(name, [float(v) for v in pos.split(",")],
                         [int(v) for v in dof.split(",")])
        refresh()

    def add_link():
        pair = simpledialog.askstring("Link", "parent,child:")
        if not pair:
            return
        a, b = [s.strip() for s in pair.split(",")]
        builder.link(a, b)
        refresh()

    def save():
        problems = builder.validate()
        if problems:
            messagebox.showwarning("validate", "\n".join(problems))
        fpath = simpledialog.askstring("Save", "path:",
                                       initialvalue=f"{project_dir}/skeletons/skeleton.pickle")
        if fpath:
            builder.save(fpath)
            messagebox.showinfo("Saved", fpath)

    bar = tk.Frame(root)
    bar.pack(pady=4)
    tk.Button(bar, text="Add part", command=add_part).pack(side=tk.LEFT, padx=4)
    tk.Button(bar, text="Add link", command=add_link).pack(side=tk.LEFT, padx=4)
    tk.Button(bar, text="Save", command=save).pack(side=tk.LEFT, padx=4)
    root.mainloop()
    return builder
