from .manhattan import (ManhattanGrid, ManhattanSimulator, SimulationArgs,
                        GridRobot, GridBeacon)
