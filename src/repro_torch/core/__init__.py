"""Scheduling core of the port: the locality model, the draw seam, the
policy registry and the five dense policies, the simulator entry points
(dense and fleet paths) and the robustness study."""
