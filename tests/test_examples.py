"""Smoke tests for the examples (tiny shapes, on the CPU)."""

import pathlib
import runpy
import sys

EXAMPLES = pathlib.Path(__file__).resolve().parent.parent / 'examples'


def test_iterative_solver(monkeypatch, capsys):
  monkeypatch.setattr(sys, 'argv', ['iterative_solver.py', '48', '64'])
  runpy.run_path(str(EXAMPLES / 'iterative_solver.py'),
                 run_name='__main__')
  assert 'converged' in capsys.readouterr().out


def test_image_pipeline(monkeypatch, capsys):
  monkeypatch.setattr(sys, 'argv', ['image_pipeline.py'])
  runpy.run_path(str(EXAMPLES / 'image_pipeline.py'), run_name='__main__')
  assert 'edge response' in capsys.readouterr().out
