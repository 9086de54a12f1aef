"""Median host time of the train step's `step.loss` span, ms a step."""

from benchlib import program_records


def read(run):
    return program_records.median_ms(run, "step.loss")
