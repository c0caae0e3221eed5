"""Vehicles (counterpart of ``chrono_tpu.vehicle``).

Ported so far: ``suspension`` (every corner and axle template, built on
``physics.builder.SystemBuilder``), which the vehicle-on-CRM demo's
four double-wishbone corners need.  The wheeled-vehicle model
(``wheeled``), tires, terrain models, the powertrain, the driver, tracked
vehicles and ``models/`` wait for ROADMAP Queue 1 item 4.
"""
