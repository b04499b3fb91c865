"""Simulator core of the port: params, traces, engine, metrics."""
