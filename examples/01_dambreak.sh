#!/bin/sh
# 2-D validated dam break (Koshizuka & Oka 1996), the reference's headline
# example (examples/main/01_DamBreak).  Runs the SHIPPED case XML.
exec python -m dualsphysics_multilayer.cli \
    -case /root/reference/examples/main/01_DamBreak/CaseDambreakVal2D_Def.xml \
    -dirout out_dambreak -sv:binx,vtk -svres "$@"
