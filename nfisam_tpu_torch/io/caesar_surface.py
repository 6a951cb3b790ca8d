"""The Caesar.jl / IncrementalInference.jl API surface the bridge emits.

Counterpart of ``nfisam_tpu/io/caesar_surface.py``.  No Julia runs here,
so what is pinned is the grammar: ``ALLOWED_LINES`` holds one regular
expression for each statement form an emitted script may contain, in the
call shapes RoME.jl / IncrementalInference.jl document and the
reference's own bridge used (``src/external/caesar/fg2caesar.jl:265-300``
for addVariable!/addFactor! with Pose2, Point2, PriorPose2, Pose2Pose2,
Pose2Point2Range and multihypo; :320-380 for solveTree!, getBelief and
getPoints).  ``validate_script`` lists the statements that match none.
"""
import re

# one regex per permitted statement form (fullmatch, after strip)
ALLOWED_LINES = [
    r"",                                        # blank
    r"#.*",                                     # comment
    r"using RoME, IncrementalInference, Distributions",
    r"using DelimitedFiles",
    r"fg = initfg\(\)",
    r'output_dir = "[^"]+"',
    r"mkpath\(output_dir\)",
    r"getSolverParams\(fg\)\.N = \d+",
    # addVariable!(fg, :X0, Pose2) | Point2
    r"addVariable!\(fg, :[A-Za-z]\w*, (Pose2|Point2)\)",
    # PriorPose2 on one variable
    r"addFactor!\(fg, \[:[A-Za-z]\w*\], PriorPose2\(MvNormal\("
    r"\[[^\]]+\], \[[^\]]+\]\)\)\)",
    # Pose2Pose2 between two variables
    r"addFactor!\(fg, \[:[A-Za-z]\w*, :[A-Za-z]\w*\], "
    r"Pose2Pose2\(MvNormal\(\[[^\]]+\], \[[^\]]+\]\)\)\)",
    # Pose2Point2Range between pose and landmark
    r"addFactor!\(fg, \[:[A-Za-z]\w*, :[A-Za-z]\w*\], "
    r"Pose2Point2Range\(Normal\([^)]+\)\)\)",
    # multihypo data association (>=2 observed candidates)
    r"addFactor!\(fg, \[:[A-Za-z]\w*(?:, :[A-Za-z]\w*){2,}\], "
    r"(Pose2Point2Range\(Normal\([^)]+\)\)|"
    r"Pose2Pose2\(MvNormal\(\[[^\]]+\], \[[^\]]+\]\)\)), "
    r"multihypo=\[[^\]]+\]\)",
    r"tree = solveTree!\(fg\)",
    r'open\(joinpath\(output_dir, "step\d+"\), "w"\) do io',
    r"writedlm\(io, getPoints\(getBelief\(fg, :[A-Za-z]\w*\)\)'\)",
    r"end",
]

_COMPILED = [re.compile(p) for p in ALLOWED_LINES]


def validate_script(script: str):
    """(line number, line) of every statement that matches no form of
    ``ALLOWED_LINES``; empty when the script conforms."""
    bad = []
    for i, raw in enumerate(script.splitlines(), start=1):
        line = raw.strip()
        if not any(p.fullmatch(line) for p in _COMPILED):
            bad.append((i, line))
    return bad
