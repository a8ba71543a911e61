"""The port's native host engine: temporal NMS and the moment postprocess
in C++ (engine.cpp), built with g++ at first use (lib.py)."""
